"""PyTorch/CUDA port of the NeuraLUT-Assemble serving path.

The package mirrors ``repro`` module for module (``repro_torch.backends.fused``
is the counterpart of ``repro.backends.fused``) and reads and writes the same
``.npz`` artifacts.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; on the CPU every kernel is replaced by its plain
PyTorch version, which is what the tests hold against the JAX reference.
"""
