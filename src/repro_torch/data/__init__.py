"""Datasets and the LM token corpus of the port (numpy only)."""
