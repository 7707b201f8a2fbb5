"""``disc_ms.gan``: Device ms per step launched inside the program span
``nn.discriminator``: the conditioned discriminator's three forwards a step
(the fakes through the frozen discriminator, then the reals and the
detached fakes), from the GAN driver's third traced pass."""
from __future__ import annotations


def read(rec):
    return rec.extra.get("disc_ms")
