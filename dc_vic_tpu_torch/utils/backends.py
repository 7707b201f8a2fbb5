"""Scoped numeric settings of PyTorch's CUDA backends.

The codec and the trainer each want their own cuDNN and TF32 settings; each
enters ``backend_flags`` around its own calls, which puts the process-wide
values back on the way out (also after an exception), so neither changes
what the other, or the caller, runs with.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch


@contextlib.contextmanager
def backend_flags(allow_tf32: Optional[bool] = None, deterministic: Optional[bool] = None,
                  benchmark: Optional[bool] = None):
    """Set ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` (both to ``allow_tf32``),
    ``torch.backends.cudnn.deterministic`` and ``torch.backends.cudnn.benchmark``
    inside the block; None leaves a setting as it is."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    try:
        if allow_tf32 is not None:
            cudnn.allow_tf32 = matmul.allow_tf32 = allow_tf32
        if deterministic is not None:
            cudnn.deterministic = deterministic
        if benchmark is not None:
            cudnn.benchmark = benchmark
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = before
