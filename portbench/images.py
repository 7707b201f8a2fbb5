"""Seeded synthetic photographs: smooth low-frequency content plus
sensor-like noise (the law of the program's deployment workload,
``tools/workload.py::smooth_images``), with each image's frequencies and
phases drawn from the seed so that a pool holds distinct images. Made on
the device in a few large calls."""
from __future__ import annotations

import math

import numpy as np
import torch


def image_pool(n: int, H: int, W: int, seed: int, device) -> np.ndarray:
    """[n, H, W, 3] uint8, the same for the same seed."""
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    f = torch.rand((n, 2), generator=g, device=device) * 3.0 + 2.5      # periods over the image
    ph = torch.rand((n, 3), generator=g, device=device) * 2.0 * math.pi
    yy = torch.linspace(0.0, 1.0, H, device=device)[None, :, None, None]
    xx = torch.linspace(0.0, 1.0, W, device=device)[None, None, :, None]
    fy, fx = f[:, 0, None, None, None], f[:, 1, None, None, None]
    p = ph[:, None, None, :]
    base = (torch.sin(yy * fy + p) * torch.cos(xx * fx * 0.7 + p) + 1.0) * 110.0
    noise = torch.randn((n, H, W, 3), generator=g, device=device) * 12.0
    return torch.clamp(base + noise, 0, 255).to(torch.uint8).cpu().numpy()
