"""Seeded weights of a configuration's model, made on the device in a few
large draws and handed alike to the program and to the plain reference.

The law follows the model's published initialisers: lecun-normal conv and
dense weights truncated at two standard deviations, zero biases, unit
norms, a U(-1/n, 1/n) codebook, N(0, 0.02) relative-position biases
truncated at two standard deviations, and the factorised bottleneck's own
scheme. Truncated normals come from one uniform draw through the inverse
normal CDF. Then the configuration's ``rate_scale`` multiplies the
analysis transform (``encoder.*``), so that random weights write about the
rate a trained model writes, and the stacks that the configuration serves
in bfloat16 get their conv and dense weights rounded to bfloat16 once, so
both sides hold exactly the served values.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from .reference import dcvic

_LO, _HI = 0.5 * math.erfc(2.0 / math.sqrt(2.0)), 1.0 - 0.5 * math.erfc(2.0 / math.sqrt(2.0))
# the standard deviation of a unit normal truncated at +-2
_TRUNC_STD = 0.87962566103423978


def _plan(model: nn.Module):
    """(name, kind, scale) of each parameter: kind "trunc" (scale = std),
    "uniform" (scale = half-width), "const" (scale = value) or "bottleneck"."""
    plan = []
    for mname, m in model.named_modules():
        own = dict(m.named_parameters(recurse=False))
        key = lambda p: f"{mname}.{p}" if mname else p
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            plan.append((key("weight"), "trunc", 1.0 / math.sqrt(fan_in) / _TRUNC_STD))
        elif isinstance(m, nn.ConvTranspose2d):
            fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
            plan.append((key("weight"), "trunc", 1.0 / math.sqrt(fan_in) / _TRUNC_STD))
        elif isinstance(m, nn.Embedding):
            plan.append((key("weight"), "uniform", 1.0 / m.num_embeddings))
        elif isinstance(m, (dcvic.GroupNorm, nn.LayerNorm)):
            plan.append((key("weight"), "const", 1.0))
        elif isinstance(m, dcvic.WindowAttention):
            plan.append((key("relative_position_bias_table"), "trunc", 0.02))
        elif isinstance(m, dcvic.EntropyBottleneck):
            plan.extend((key(p), "bottleneck", 0.0) for p in own)
            continue
        if "bias" in own and own["bias"] is not None:
            plan.append((key("bias"), "const", 0.0))
    return plan


def make_weights(model: nn.Module, seed: int, device, rate_scale: float = 1.0,
                 bf16_stacks=()) -> Dict[str, torch.Tensor]:
    """The state dict of ``model``'s structure (a reference model, which
    may lie on the meta device), drawn from ``seed`` on ``device``."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    plan = _plan(model)
    missing = set(shapes) - {n for n, _, _ in plan}
    if missing:
        raise ValueError(f"no initialiser for {sorted(missing)[:3]}")
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    sizes = [math.prod(shapes[n]) for n, _, _ in plan]
    u = torch.rand(sum(sizes), generator=g, device=device, dtype=torch.float64)
    out, at = {}, 0
    for (name, kind, scale), n in zip(plan, sizes):
        part = u[at:at + n].reshape(shapes[name])
        at += n
        if kind == "trunc":
            w = torch.special.ndtri(_LO + (_HI - _LO) * part) * scale
        elif kind == "uniform":
            w = (2.0 * part - 1.0) * scale
        elif kind == "const":
            w = torch.full(shapes[name], scale, dtype=torch.float64, device=device)
        else:
            w = _bottleneck(name, shapes[name], part)
        out[name] = w.to(torch.float32)
    del u
    for name in out:
        if name.startswith("encoder."):
            out[name] = out[name] * rate_scale
    for mname, m in model.named_modules():
        if mname.split(".")[0] in bf16_stacks and isinstance(
                m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            for p in ("weight", "bias"):
                k = f"{mname}.{p}"
                if k in out:
                    out[k] = out[k].to(torch.bfloat16).to(torch.float32)
    return out


def _bottleneck(name: str, shape, u: torch.Tensor) -> torch.Tensor:
    """The factorised bottleneck's init: softplus^-1 of 1 / (scale * cols)
    matrices, U(-0.5, 0.5) biases, zero factors, quantiles (-10, 0, 10)."""
    leaf = name.rsplit(".", 1)[1]
    K = 5
    if leaf.startswith("_matrix"):
        scale = 10.0 ** (1.0 / K)
        return torch.full(shape, math.log(math.expm1(1.0 / scale / shape[2])),
                          dtype=torch.float64, device=u.device)
    if leaf.startswith("_bias"):
        return u - 0.5
    if leaf.startswith("_factor"):
        return torch.zeros(shape, dtype=torch.float64, device=u.device)
    return torch.tensor([-10.0, 0.0, 10.0], dtype=torch.float64,
                        device=u.device).expand(shape).clone()
