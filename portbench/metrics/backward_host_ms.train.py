"""``backward_host_ms.train``: Host ms per step inside the program span
``train.backward``: the host's part of the backward pass (autograd queues
the kernels from its own thread while the span is open)."""
from __future__ import annotations

from portbench import program


def read(rec):
    return program.host_ms_per("train.backward", "train.update")
