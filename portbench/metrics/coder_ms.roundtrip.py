"""``coder_ms.roundtrip``: Device ms per batch of the rANS coder kernels
(rans_*: R1 encode, R2 decode)."""
from __future__ import annotations


def read(rec):
    return rec.device_ms_per_unit(lambda n: "rans_" in n)
