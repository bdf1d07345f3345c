"""Kernels of the port, each beside its plain PyTorch version."""
