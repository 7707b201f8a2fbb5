"""The arithmetic of ``csrc/tf32x3.cuh`` in plain PyTorch: the TF32 split of
an f32 value and the error-compensated three-product sum the attention and
conv kernels take on the tensor cores. Nothing on the codec's path calls
this module; the tests use it to show why the kernels keep their f32
tolerances, and it documents the kernels' numerics in runnable form.

TF32 keeps f32's sign and exponent and the upper 10 of its 23 mantissa bits.
"""
from __future__ import annotations

from typing import Tuple

import torch

_LOW13 = 0x1FFF     # the mantissa bits TF32 drops
_HALF = 0x1000      # half a unit of TF32's last place


def _bits(a: torch.Tensor) -> torch.Tensor:
    if a.dtype != torch.float32:
        raise TypeError(f"expected a float32 tensor, got {a.dtype}")
    return a.contiguous().view(torch.int32)


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """a to the nearest TF32 value, ties away from zero (what
    ``cvt.rna.tf32.f32`` gives), by integer arithmetic on the bits as the
    kernels do it. Zeros and infinities come back unchanged."""
    return ((_bits(a) + _HALF) & ~_LOW13).view(torch.float32)


def cut_tf32(a: torch.Tensor) -> torch.Tensor:
    """a with the 13 low mantissa bits cleared: what a tensor core reads of
    an f32 register handed to it as a TF32 operand."""
    return (_bits(a) & ~_LOW13).view(torch.float32)


def split_tf32(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = round_tf32(a) and lo = round_tf32(a - hi). The
    difference a - hi is exact in f32; hi + lo is within 2^-22 of a. An
    infinite a has hi = a and a NaN lo, as in the kernels. (The kernels add
    half a unit to the bits of a - hi and let the tensor core cut the low
    bits off, which is the same value.)"""
    hi = round_tf32(a)
    return hi, round_tf32(a - hi)


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to TF32 once (no compensation) and
    the sum carried in float64: the error of one plain TF32 product."""
    return (round_tf32(a).double() @ round_tf32(b).double()).float()


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor, chain: int = 8) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the kernels compute it: both operands split,
    a_lo b_hi + a_hi b_lo + a_hi b_hi with a_lo b_lo dropped; each group of
    ``chain`` consecutive k is summed exactly (the tensor core's short
    chain, here in float64) and rounded to f32, and the groups are added one
    after the other in f32 (the rounded adds outside the tensor cores)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected [M, K] and [K, N], got {tuple(a.shape)}, {tuple(b.shape)}")
    a_hi, a_lo = (t.double() for t in split_tf32(a))
    b_hi, b_lo = (t.double() for t in split_tf32(b))
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], chain):
        k = slice(k0, k0 + chain)
        part = a_lo[:, k] @ b_hi[k] + a_hi[:, k] @ b_lo[k] + a_hi[:, k] @ b_hi[k]
        acc = acc + part.float()
    return acc
