"""What the program records about itself in a traced run: the host seconds
and entries of its spans and its counters (``dc_vic_tpu_torch/ops/counts.py``:
``spans``, ``counters``). The program adds them up only while a profiler
records, apart for sessions that record the card alone and those that
record the host's operations too. On a card the readings come from the
first (the device-only pass of ``trace.two_passes``), whose host times
carry only the spans' own cost; without a card both passes record the host,
and the readings cover both. A reading per request or per step divides by
the entries of the span that marks one, which the same pass counted. A
program that records no spans (one from before them) gives None for every
reading."""
from __future__ import annotations

from typing import Dict, Optional, Tuple


def _totals() -> Optional[Tuple[Dict[str, Tuple[float, int]], Dict[str, int]]]:
    try:
        import torch
        from dc_vic_tpu_torch.ops import counts
    except ImportError:
        return None
    if not (hasattr(counts, "spans") and hasattr(counts, "counters")):
        return None
    host = not torch.cuda.is_available()
    return counts.spans(host), counts.counters(host)


def host_ms_per(span: str, unit: str) -> Optional[float]:
    """Host ms inside the program span ``span`` per entry of the span
    ``unit`` (a request, a step); None where either was never entered."""
    got = _totals()
    if got is None:
        return None
    spans = got[0]
    if span not in spans or spans.get(unit, (0.0, 0))[1] <= 0:
        return None
    return spans[span][0] * 1e3 / spans[unit][1]


def count_per(counter: str, unit: str) -> Optional[float]:
    """The program counter ``counter`` per entry of the span ``unit``; None
    where the span was never entered or the program keeps no counters."""
    got = _totals()
    if got is None:
        return None
    spans, counters = got
    if spans.get(unit, (0.0, 0))[1] <= 0:
        return None
    return counters.get(counter, 0) / spans[unit][1]
