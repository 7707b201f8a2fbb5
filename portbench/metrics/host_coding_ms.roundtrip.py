"""``host_coding_ms.roundtrip``: Host ms per batch in Codec.compress_finalize
once the device encode has been waited for (stage spans of the benchmark,
each ended by a synchronize)."""
from __future__ import annotations


def read(rec):
    return rec.stage_ms("host_coding")
