"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Importing this package builds nothing: the CUDA library is compiled at the
first launch (``kernels.build``).
"""
