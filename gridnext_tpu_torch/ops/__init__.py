"""Kernels of the port (CUDA C++ in ``csrc/``) and their plain versions."""
