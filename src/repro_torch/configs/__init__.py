"""Model configurations of the port: the paper's Table II designs and the
LM architectures."""
