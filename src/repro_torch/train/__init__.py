"""Training: optimizer, losses and the LUT-model trainer."""
