"""GUST kernels for Hopper (CUDA C++ in ``csrc/``): SpMV, SpGEMM and the
Buffer Filler, with their wrappers, plain PyTorch versions and the
executor."""
