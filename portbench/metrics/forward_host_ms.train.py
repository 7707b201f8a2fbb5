"""``forward_host_ms.train``: Host ms per step inside the program span
``train.forward``: the model's forward and the losses, LPIPS included."""
from __future__ import annotations

from portbench import program


def read(rec):
    return program.host_ms_per("train.forward", "train.update")
