"""``chain_host_ms.decode``: Host ms per request inside the program span
``codec.decode.chain``: the z section, the hyperdecoder and the six ChARM
sections (R2 and the chain step each), queued without a wait."""
from __future__ import annotations

from portbench import program


def read(rec):
    return program.host_ms_per("codec.decode.chain", "codec.decompress")
