"""``host_waits.decode``: The codec's copies to the host that the host
waits for, per request (the program counter ``host_waits``)."""
from __future__ import annotations

from portbench import program


def read(rec):
    return program.count_per("host_waits", "codec.decompress")
