"""The kernel wrappers' counters, read and reset together.

Each wrapper adds one to its launch count where it launches its kernel on the
card, and each kernel's ``autograd.Function`` adds one to its backward count
where its backward runs on CUDA tensors; on CPU tensors both stay at 0.
"""
from __future__ import annotations

from typing import Dict

from . import attention, conv3x3, gn, rans_device, vq


def launches() -> Dict[str, int]:
    """Every kernel's launches since the last ``reset``."""
    return {"vq_argmin": vq.launches, "flash_attention": attention.launches, **gn.launches,
            **conv3x3.launches, **rans_device.launches}


def backwards() -> Dict[str, int]:
    """Every kernel Function's backwards since the last ``reset``."""
    return {"flash_attention": attention.backwards, **gn.backwards, **conv3x3.backwards}


def reset() -> None:
    """Set every launch and backward count to 0."""
    vq.launches = 0
    attention.launches = 0
    attention.backwards = 0
    for table in (gn.launches, conv3x3.launches, rans_device.launches, gn.backwards,
                  conv3x3.backwards):
        for name in table:
            table[name] = 0
