"""``conv3x3_roofline.roundtrip``: K5+K6: the 3x3 conv calls' summed bound
(roofline.conv3x3_call) over the device time of the conv3x3 kernels and
their weight repacks; read only where the conv3x3 launches match the calls
counted."""
from __future__ import annotations


def read(rec):
    return rec.roofline("conv3x3", lambda n: "conv3x3" in n, lambda n: "repack_weights" in n)
