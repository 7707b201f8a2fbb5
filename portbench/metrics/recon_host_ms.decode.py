"""``recon_host_ms.decode``: Host ms per request inside the program span
``codec.reconstruct``: the decoder features, the VQ estimator and the VQGAN
decoder with its fusion."""
from __future__ import annotations

from portbench import program


def read(rec):
    return program.host_ms_per("codec.reconstruct", "codec.decompress")
