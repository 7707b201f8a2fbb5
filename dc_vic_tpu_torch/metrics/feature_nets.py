"""The perceptual feature networks' loader (the part of
dc_vic_tpu/metrics/feature_nets.py that training reads).

The LPIPS, DISTS and Inception networks are not ported yet (ROADMAP.md queue
1): their weights are not in the repository. Training without a weights path
uses the LPIPS loss's gradient-L1 proxy, as the JAX package does; asking for
weights raises rather than silently training on the proxy.
"""
from __future__ import annotations

from typing import Optional


def load_lpips(weights_path: Optional[str], net: str = "alex"):
    """None without ``weights_path`` (the loss then takes its proxy); with
    one, NotImplementedError: LPIPS is not ported."""
    if not weights_path:
        return None
    raise NotImplementedError(
        f"LPIPS ({net}) with weights {weights_path!r} is not ported to dc_vic_tpu_torch "
        "(ROADMAP.md queue 1, item 2: the feature networks); drop the weights path to "
        "train on the gradient-L1 proxy")
