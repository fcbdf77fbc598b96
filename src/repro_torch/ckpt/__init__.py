"""Checkpointing of the port (``repro.ckpt``): :mod:`repro_torch.ckpt.
checkpoint` writes and reads the reference's on-disk format."""
