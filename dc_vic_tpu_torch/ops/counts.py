"""The program's counters, read and reset together.

Each wrapper adds one to its launch count where it launches its kernel on the
card, and each kernel's ``autograd.Function`` adds one to its backward count
where its backward runs on CUDA tensors; on CPU tensors both stay at 0. The
program spans' host totals and the counters of ``utils/profiling.py`` add up
while a profiler records, on the card and on the CPU alike, apart for sessions
that record the host's operations and those that record the card alone.
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..utils import profiling
from . import attention, conv3x3, gn, rans_device, vq


def launches() -> Dict[str, int]:
    """Every kernel's launches since the last ``reset``."""
    return {"vq_argmin": vq.launches, "flash_attention": attention.launches, **gn.launches,
            **conv3x3.launches, **rans_device.launches}


def backwards() -> Dict[str, int]:
    """Every kernel Function's backwards since the last ``reset``."""
    return {"flash_attention": attention.backwards, **gn.backwards, **conv3x3.backwards}


def spans(host: bool) -> Dict[str, Tuple[float, int]]:
    """Every program span's (host seconds, entries) since the last
    ``reset``, under profiler sessions that recorded the host's operations
    too (``host``) or the card alone."""
    with profiling.totals_lock:
        return {k: (v[0], int(v[1])) for k, v in profiling.span_totals[host].items()}


def counters(host: bool) -> Dict[str, int]:
    """Every program counter (``host_waits``) since the last ``reset``,
    under sessions that recorded the host too (``host``) or the card alone."""
    with profiling.totals_lock:
        return dict(profiling.counters[host])


def reset() -> None:
    """Set every launch, backward and program count to 0."""
    with profiling.totals_lock:
        for table in (*profiling.span_totals.values(), *profiling.counters.values()):
            table.clear()
    vq.launches = 0
    attention.launches = 0
    attention.backwards = 0
    for table in (gn.launches, conv3x3.launches, rans_device.launches, gn.backwards,
                  conv3x3.backwards):
        for name in table:
            table[name] = 0
