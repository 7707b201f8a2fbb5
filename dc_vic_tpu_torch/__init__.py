"""PyTorch/CUDA port of dc_vic_tpu for one NVIDIA H100.

Mirrors the JAX package's layout (utils, nn, models, ops, codec) with
hand-written CUDA kernels under csrc/. Imports torch, numpy and scipy only:
never jax, flax or the JAX package.
"""
