"""``update_host_ms.train``: Host ms per step inside the program span
``train.update``: the finite check and the optimizers' steps."""
from __future__ import annotations

from portbench import program


def read(rec):
    return program.host_ms_per("train.update", "train.update")
