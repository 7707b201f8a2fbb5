"""``attn_roofline.roundtrip``: K2: the attention calls' summed bound
(roofline.attention_call, 3xTF32 at 165 TFLOP/s or HBM) over the device time
of the flash_attn kernels; read only where the launches match the calls
counted."""
from __future__ import annotations


def read(rec):
    return rec.roofline("attn", lambda n: "flash_attn" in n)
