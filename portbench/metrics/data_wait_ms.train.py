"""``data_wait_ms.train``: Host ms per step the loop waits for the next batch:
the loader's next() and Trainer._to_device, in the measured window."""
from __future__ import annotations


def read(rec):
    return rec.extra.get("data_wait_ms")
