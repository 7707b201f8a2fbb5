"""``mfu.train``: Model FLOPs of the window's completed work (counted once per
shape on the plain reference with torch.utils.flop_counter, forward and
backward for training) over the window's seconds times the peak of the
configured precision (989 TFLOP/s bf16; 165 TFLOP/s for f32 as three TF32
products)."""
from __future__ import annotations


def read(rec):
    return rec.mfu()
