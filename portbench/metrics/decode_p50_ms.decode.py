"""``decode_p50_ms.decode``: The median latency of the window's decode
requests, call to pixels on the host."""
from __future__ import annotations

import statistics



def read(rec):
    lat = rec.extra.get("latencies_ms")
    return float(statistics.median(lat)) if lat else None
