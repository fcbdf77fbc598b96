"""Training: optimizer, losses, the LUT-model trainer and the LM loop."""
