"""Numeric ops: CUDA kernels with plain PyTorch versions, CDF tables, host rANS binding."""
