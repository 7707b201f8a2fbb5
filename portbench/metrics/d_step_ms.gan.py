"""``d_step_ms.gan``: Device ms per step launched inside the program span
``train.d_step`` (the discriminator's forwards on the reals and the fakes,
its loss and its backward), spans nested in it included, from the GAN
driver's third traced pass (``utils/profiling.py::span_times``)."""
from __future__ import annotations


def read(rec):
    return rec.extra.get("d_step_ms")
