"""Kernels (CUDA, built from ../csrc) and their plain PyTorch versions."""
