"""``elementwise_ms.decode``: Device ms per image of PyTorch's elementwise and
reduction kernels (the frozen grouping of trace.group_of)."""
from __future__ import annotations

from portbench import trace



def read(rec):
    return rec.group_ms_per_unit(trace.ELEMENTWISE)
