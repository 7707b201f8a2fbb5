"""``encode_ms.roundtrip``: Host ms per batch from Codec.compress_dispatch to
the end of the device encode (front, entropy chain, R1), ended by a
synchronize."""
from __future__ import annotations


def read(rec):
    return rec.stage_ms("encode")
