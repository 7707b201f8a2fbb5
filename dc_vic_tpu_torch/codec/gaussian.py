"""Conditional Gaussian entropy model (port of dc_vic_tpu/codec/gaussian.py).

Parameter-free: a frozen dataclass of tensor functions plus the host-side
CDF table builder, which runs in numpy float64 exactly as the JAX package's
does, so both packages build identical integer tables.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from scipy.special import erfc as _np_erfc
from scipy.stats import norm as _scipy_norm

from ..ops.cdf import build_cdf_rows
from ..ops.rans_host import CdfTable
from .ops import lower_bound

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def get_scale_table(smin: float = SCALES_MIN, smax: float = SCALES_MAX,
                    levels: int = SCALES_LEVELS) -> np.ndarray:
    """64 log-spaced scales in [0.11, 256] (compressai default)."""
    return np.exp(np.linspace(math.log(smin), math.log(smax), levels))


def _standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.erfc(-x * (2 ** -0.5))


@dataclasses.dataclass(frozen=True)
class GaussianConditional:
    """Mean-scale Gaussian conditional (SteGaussianMeanScaleConditional)."""
    scale_bound: float = SCALES_MIN
    likelihood_bound: float = 1e-9
    tail_mass: float = 1e-9

    # coded symbols are clipped at quantization, so y_hat and the stream agree
    SYM_CLIP = 32000

    def likelihood(self, y, scales, means):
        scales = lower_bound(scales, self.scale_bound)
        values = torch.abs(y - means)
        upper = _standardized_cumulative((0.5 - values) / scales)
        lower = _standardized_cumulative((-0.5 - values) / scales)
        lik = upper - lower
        if self.likelihood_bound > 0:
            lik = lower_bound(lik, self.likelihood_bound)
        return lik

    def quantize_symbols(self, y, means):
        return torch.clamp(torch.round(y - means), -self.SYM_CLIP,
                           self.SYM_CLIP).to(torch.int32)

    def dequantize(self, symbols, means):
        return symbols.to(means.dtype) + means

    def build_indexes(self, scales, scale_table: np.ndarray) -> torch.Tensor:
        """Index of the smallest table scale >= scale (after bounding): the
        count of table entries strictly below the scale (compressai's rule)."""
        scales = torch.clamp(scales, min=self.scale_bound).contiguous()
        table = torch.as_tensor(np.asarray(scale_table[:-1], np.float32),
                                device=scales.device)
        return torch.bucketize(scales, table, right=False).to(torch.int32)

    def build_cdf_table(self, scale_table: Optional[np.ndarray] = None) -> CdfTable:
        """Quantized CDF rows per table scale (GaussianConditional.update)."""
        scale_table = np.asarray(
            get_scale_table() if scale_table is None else scale_table, np.float64)
        multiplier = -_scipy_norm.ppf(self.tail_mass / 2)
        pmf_center = np.ceil(scale_table * multiplier).astype(np.int64)
        pmf_length = 2 * pmf_center + 1
        max_length = int(pmf_length.max())

        samples = np.abs(np.arange(max_length)[None, :] - pmf_center[:, None])
        s = scale_table[:, None]
        upper = 0.5 * _np_erfc(-((0.5 - samples) / s) / np.sqrt(2.0))
        lower = 0.5 * _np_erfc(-((-0.5 - samples) / s) / np.sqrt(2.0))
        pmf = upper - lower
        tail_mass = 2.0 * lower[:, :1]

        pmf = np.where(np.arange(max_length)[None, :] < pmf_length[:, None], pmf, 0.0)
        cdfs = build_cdf_rows(pmf, tail_mass[:, 0], pmf_length, max_length)
        return CdfTable(cdfs, pmf_length + 2, -pmf_center)
