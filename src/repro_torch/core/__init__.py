"""Config, quantization and folded-network types of the port."""
