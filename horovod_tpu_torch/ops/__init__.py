"""Kernels of the port (CUDA C++ for Hopper) and their plain versions."""
