"""Kernels written by hand for Hopper (CUDA C++ under ``repro_torch/csrc``),
each beside its plain PyTorch version."""
