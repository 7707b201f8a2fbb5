"""The deployment workload: the one configuration and traffic the codec is
timed at, shared by ``chip_smoke.py`` and ``tools/recon_ab.py --deployment``.

bf16 conv stacks with ``entropy_precision: default``, tpu stream format,
device encode backend, 512 lanes, a batch of sixteen 768x512 images of smooth
content plus noise, and encoder weights scaled by 0.55 so that random
weights land at a rate a trained model would write.
"""
from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch

DEPLOYMENT = dict(batch=16, lanes=512, rate_scale=0.55, H=768, W=512)


def smooth_images(B: int, H: int, W: int) -> np.ndarray:
    """Smooth low-frequency content plus sensor-like noise, [B, H, W, 3]
    uint8 from ``numpy.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.linspace(0, 4, H), np.linspace(0, 4, W), indexing="ij")
    base = (np.stack([np.sin(yy + p) * np.cos(xx * 0.7 + p)
                      for p in (0.0, 1.3, 2.1)], axis=-1) + 1.0) * 110.0
    return np.clip(base[None] + rng.normal(0, 12, (B, H, W, 3)), 0, 255).astype(np.uint8)


def deployment_images() -> np.ndarray:
    """The workload's batch: ``smooth_images`` [16, 768, 512, 3], seed 0."""
    return smooth_images(DEPLOYMENT["batch"], DEPLOYMENT["H"], DEPLOYMENT["W"])


def deployment_config(opt):
    """A copy of the model configuration ``opt`` with the deployment
    numerics set."""
    opt = copy.deepcopy(opt)
    opt["codec_dtype"], opt["entropy_precision"] = "bfloat16", "default"
    return opt


def scale_encoder(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of an f32 state dict with the encoder's parameters scaled by
    the workload's rate scale."""
    return {k: (v * DEPLOYMENT["rate_scale"] if k.startswith("encoder.") else v.clone())
            for k, v in state_dict.items()}
