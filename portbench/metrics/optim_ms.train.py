"""``optim_ms.train``: Device ms per step of the multi-tensor (_foreach)
kernels: the optimizers' clip and Adam updates."""
from __future__ import annotations


def read(rec):
    return rec.device_ms_per_unit(lambda n: "multi_tensor_apply" in n)
