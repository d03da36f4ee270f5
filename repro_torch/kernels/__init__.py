"""GUST SpMV kernels for Hopper (CUDA C++ in ``csrc/``), their wrappers,
plain PyTorch versions and the executor."""
