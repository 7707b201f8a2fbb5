"""Memory layout of tensors handed to kernels and to the entropy chain."""
from __future__ import annotations

import torch


def row_major(t: torch.Tensor) -> torch.Tensor:
    """t with the row-major strides of its shape. The strides pick the
    convolution kernel (a channels-last layout takes another kernel with
    another summation order), and a view such as a permuted [B, C, 1, 1]
    tensor counts as contiguous while it still reads as channels-last. The
    entropy chain passes its inputs through this, so the encoder and the
    decoder compute on the same layout whatever produced their tensors; the
    kernel wrappers do, because a kernel indexes memory by shape alone."""
    want, step = [], 1
    for n in reversed(t.shape):
        want.append(step)
        step *= n
    if tuple(reversed(want)) == t.stride():
        return t
    return t.clone(memory_format=torch.contiguous_format)


def widen(t: torch.Tensor) -> torch.Tensor:
    """t in f32, the plain versions' arithmetic type; float64 stays float64
    (so that their gradients can be checked in double precision)."""
    return t if t.dtype == torch.float64 else t.float()
