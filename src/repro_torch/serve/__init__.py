"""Serving layer of the port: the micro-batching LUT engine and the LM
serving engine."""
