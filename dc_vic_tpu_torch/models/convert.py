"""Loading weights in the reference's torch layout.

The port's parameter names are the reference's state-dict keys, so a dict
in that layout (the JAX package's ``export_state_dict`` output, or a
released ``.pth.tar``'s ``comp_model`` entry as numpy arrays) loads as is.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def load_reference_state_dict(model: nn.Module, sd: Dict[str, np.ndarray]) -> None:
    """Load ``sd`` (numpy arrays keyed by reference torch names) strictly:
    raise on any missing or extra key or any shape that does not match.

    Dense layers are stored 2-D here; a 1x1-conv weight (O, I, 1, 1), as
    the reference stores its FiLM and quant convs, is accepted for them."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"state dict does not match the model: missing {missing}, "
                       f"unexpected {extra}")
    tensors = {}
    for key, value in sd.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        want = own[key].shape
        if t.shape != want and t.dim() == 4 and t.shape[2:] == (1, 1) \
                and t.shape[:2] == want:
            t = t[:, :, 0, 0]
        if t.shape != want:
            raise ValueError(f"shape mismatch for {key}: got {tuple(t.shape)}, "
                             f"model has {tuple(want)}")
        tensors[key] = t.to(own[key].dtype)
    model.load_state_dict(tensors, strict=True)
