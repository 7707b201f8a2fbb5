"""``decode_ms.roundtrip``: Host ms per batch from Codec.decompress (fetch
deferred) to the end of the device decode (R2, entropy chain,
reconstruction), ended by a synchronize."""
from __future__ import annotations


def read(rec):
    return rec.stage_ms("decode")
