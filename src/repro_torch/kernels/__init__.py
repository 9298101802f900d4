"""Hand-written CUDA kernels for Hopper (``csrc/``), each with a plain
PyTorch version of the same function beside its wrapper."""
