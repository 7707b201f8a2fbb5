"""Image quality metrics: PSNR, SSIM, MS-SSIM (port of
dc_vic_tpu/metrics/image.py).

PSNR follows the reference protocol: uint8-rounded pixels, data range 255.
SSIM and MS-SSIM follow pytorch_msssim (separable 11-tap Gaussian, valid
filtering, 2x2 average pooling with odd sides zero-padded on both ends) and
are differentiable torch functions on NCHW tensors in [0, 1]; the MS-SSIM
loss trains through them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _host(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().float().cpu().numpy()
    return np.asarray(img)


def tensor_to_uint8(img) -> np.ndarray:
    """[-1, 1] floats (any layout; array or tensor) -> uint8, the
    reference's rounding."""
    x = (np.clip(_host(img), -1.0, 1.0) + 1.0) / 2.0 * 255.0
    return np.round(x).astype(np.uint8)


def calc_psnr(real, fake, data_range: float = 255.0) -> float:
    """PSNR of two images in [-1, 1] on their uint8-rounded values."""
    a = tensor_to_uint8(real).astype(np.float64)
    b = tensor_to_uint8(fake).astype(np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _gauss_1d(size: int, sigma: float, like: torch.Tensor) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32, device=like.device) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / torch.sum(g)).to(like.dtype)


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode Gaussian filter of an NCHW map, per channel."""
    C, k = x.shape[1], win.shape[0]
    x = F.conv2d(x, win.reshape(1, 1, k, 1).expand(C, 1, k, 1), groups=C)
    return F.conv2d(x, win.reshape(1, 1, 1, k).expand(C, 1, 1, k), groups=C)


def _ssim_components(x, y, win, data_range: float = 1.0):
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    mu_x, mu_y = _blur(x, win), _blur(y, win)
    sxx = _blur(x * x, win) - mu_x ** 2
    syy = _blur(y * y, win) - mu_y ** 2
    sxy = _blur(x * y, win) - mu_x * mu_y
    cs = (2 * sxy + C2) / (sxx + syy + C2)
    s = ((2 * mu_x * mu_y + C1) / (mu_x ** 2 + mu_y ** 2 + C1)) * cs
    return s.mean(dim=(1, 2, 3)), cs.mean(dim=(1, 2, 3))


def ssim(x: torch.Tensor, y: torch.Tensor, win_size: int = 11,
         win_sigma: float = 1.5) -> torch.Tensor:
    """Single-scale SSIM per image [B]; NCHW inputs in [0, 1]."""
    s, _ = _ssim_components(x, y, _gauss_1d(win_size, win_sigma, x))
    return s


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, win_size: int = 11,
            win_sigma: float = 1.5) -> torch.Tensor:
    """Multi-scale SSIM per image [B]; NCHW inputs in [0, 1], min(H, W) >
    (win_size - 1) * 2^4."""
    win = _gauss_1d(win_size, win_sigma, x)
    weights = torch.tensor(_MSSSIM_WEIGHTS, dtype=x.dtype, device=x.device)
    vals = []
    for i in range(len(_MSSSIM_WEIGHTS)):
        s, cs = _ssim_components(x, y, win)
        vals.append(s if i == len(_MSSSIM_WEIGHTS) - 1 else cs)
        if i < len(_MSSSIM_WEIGHTS) - 1:
            pad = (x.shape[2] % 2, x.shape[3] % 2)
            x = F.avg_pool2d(x, 2, 2, padding=pad, count_include_pad=True)
            y = F.avg_pool2d(y, 2, 2, padding=pad, count_include_pad=True)
    vals = torch.clamp(torch.stack(vals, dim=0), min=1e-12)     # [levels, B]
    return torch.exp(torch.sum(weights[:, None] * torch.log(vals), dim=0))


def calc_ms_ssim(real, fake) -> float:
    """Mean MS-SSIM of NCHW images in [-1, 1] (arrays or tensors); -1 for
    images under the five-scale window's support (160 px) or a non-finite
    score (the reference wrapper's convention)."""
    if min(real.shape[2], real.shape[3]) <= 160:
        return -1.0
    a = (torch.as_tensor(_host(real)).float() + 1.0) / 2.0
    b = (torch.as_tensor(_host(fake)).float() + 1.0) / 2.0
    v = float(torch.mean(ms_ssim(a, b)))
    return v if np.isfinite(v) else -1.0
