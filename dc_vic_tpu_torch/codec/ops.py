"""Small codec primitives (port of dc_vic_tpu/codec/ops.py)."""
from __future__ import annotations

import torch


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """max(x, bound). The codec runs under no_grad, so the one-sided
    gradient of the JAX version is not needed here."""
    return torch.clamp(x, min=bound)
