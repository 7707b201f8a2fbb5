"""``peak_gib.decode``: torch.cuda.max_memory_allocated over the measured
window (reset after set-up), in GiB."""
from __future__ import annotations


def read(rec):
    return rec.peak_bytes / 2 ** 30 if rec.peak_bytes else None
