"""``launches_per_image.decode``: CUDA kernels launched per single-image decode
in the profiled window (copies and fills not counted)."""
from __future__ import annotations


def read(rec):
    n = rec.prof["kernel_launches"]
    return n / rec.prof_units if n and rec.prof_units else None
