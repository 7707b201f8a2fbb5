"""``d_step_host_ms.gan``: Host ms per step inside the program span
``train.d_step``: the host's part of the discriminator's half of the GAN
step (its forwards, its loss, autograd queueing its backward)."""
from __future__ import annotations

from portbench import program


def read(rec):
    return program.host_ms_per("train.d_step", "train.update")
