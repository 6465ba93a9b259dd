"""Tensor ops of the port (plain PyTorch) and, under `cuda/`, the kernels."""
