"""Fully factorized entropy bottleneck for z (port of
dc_vic_tpu/codec/bottleneck.py).

Parameters carry the reference's torch names (``_matrix{i}``, ``_bias{i}``,
``_factor{i}``, ``quantiles``). The CDF tables are built on the host in
float64 numpy, as in the JAX package: the tables define the bitstream and
must not depend on the device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..ops.cdf import build_cdf_rows
from ..ops.rans_host import CdfTable
from .ops import lower_bound


class EntropyBottleneck(nn.Module):
    def __init__(self, channels: int, filters: Tuple[int, ...] = (3, 3, 3, 3),
                 likelihood_bound: float = 1e-9):
        super().__init__()
        self.channels = channels
        self.likelihood_bound = likelihood_bound
        sizes = (1,) + tuple(filters) + (1,)
        self.num_layers = len(filters) + 1
        for i in range(self.num_layers):
            self.register_parameter(
                f"_matrix{i}", nn.Parameter(torch.empty(channels, sizes[i + 1], sizes[i])))
            self.register_parameter(
                f"_bias{i}", nn.Parameter(torch.empty(channels, sizes[i + 1], 1)))
            if i < self.num_layers - 1:
                self.register_parameter(
                    f"_factor{i}", nn.Parameter(torch.empty(channels, sizes[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.empty(channels, 1, 3))

    def medians(self) -> torch.Tensor:
        return self.quantiles[:, 0, 1]

    def _logits_cumulative(self, inputs: torch.Tensor) -> torch.Tensor:
        """inputs [C, 1, N] -> logits of the learned cumulative."""
        logits = inputs
        for i in range(self.num_layers):
            m = nn.functional.softplus(getattr(self, f"_matrix{i}"))
            logits = torch.matmul(m, logits) + getattr(self, f"_bias{i}")
            if i < self.num_layers - 1:
                logits = logits + torch.tanh(getattr(self, f"_factor{i}")) * torch.tanh(logits)
        return logits

    def likelihood(self, x_hat: torch.Tensor) -> torch.Tensor:
        """Likelihood of quantized values x_hat [B, C, H, W]."""
        B, C, H, W = x_hat.shape
        v = x_hat.transpose(0, 1).reshape(C, 1, -1)
        lower = self._logits_cumulative(v - 0.5)
        upper = self._logits_cumulative(v + 0.5)
        sign = -torch.sign(lower + upper)
        lik = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        if self.likelihood_bound > 0:
            lik = lower_bound(lik, self.likelihood_bound)
        return lik.reshape(C, B, H, W).transpose(0, 1)

    def quantize_symbols(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW -> int32 symbols around the per-channel median, clipped to
        the int16 transport range."""
        med = self.medians().reshape(1, -1, 1, 1)
        return torch.clamp(torch.round(x - med), -32000, 32000).to(torch.int32)

    def dequantize(self, symbols: torch.Tensor) -> torch.Tensor:
        med = self.medians().reshape(1, -1, 1, 1)
        return symbols.to(torch.float32) + med


def _np_logits_cumulative(p: dict, inputs: np.ndarray, num_layers: int) -> np.ndarray:
    logits = np.asarray(inputs, np.float64)
    for i in range(num_layers):
        m = np.logaddexp(0.0, np.asarray(p[f"_matrix{i}"], np.float64))
        logits = np.matmul(m, logits) + np.asarray(p[f"_bias{i}"], np.float64)
        if i < num_layers - 1:
            f = np.tanh(np.asarray(p[f"_factor{i}"], np.float64))
            logits = logits + f * np.tanh(logits)
    return logits


def _np_sigmoid(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def build_bottleneck_cdf(module: EntropyBottleneck) -> CdfTable:
    """Offline CDF table construction (EntropyBottleneck.update), entirely
    in host float64."""
    p = {k: v.detach().cpu().numpy() for k, v in module.named_parameters()}
    q = p["quantiles"]
    medians = q[:, 0, 1].astype(np.float64)
    minima = np.clip(np.ceil(medians - q[:, 0, 0]), 0, None).astype(np.int64)
    maxima = np.clip(np.ceil(q[:, 0, 2] - medians), 0, None).astype(np.int64)
    pmf_length = minima + maxima + 1
    max_length = int(pmf_length.max())
    pmf_start = medians - minima

    C = module.channels
    samples = (np.arange(max_length)[None, :] + pmf_start[:, None]).reshape(C, 1, -1)

    lower = _np_logits_cumulative(p, samples - 0.5, module.num_layers)
    upper = _np_logits_cumulative(p, samples + 0.5, module.num_layers)
    sign = -np.sign(lower + upper)
    pmf = np.abs(_np_sigmoid(sign * upper) - _np_sigmoid(sign * lower))
    pmf = pmf.reshape(C, -1)
    tail = _np_sigmoid(lower[:, 0, 0]) + _np_sigmoid(-upper[:, 0, -1])

    pmf = np.where(np.arange(max_length)[None, :] < pmf_length[:, None], pmf, 0.0)
    cdfs = build_cdf_rows(pmf, tail, pmf_length, max_length)
    return CdfTable(cdfs, pmf_length + 2, -minima)
