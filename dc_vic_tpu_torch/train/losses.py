"""Training losses (port of dc_vic_tpu/train/losses.py), as callables over
torch tensors that carry their weight (``loss_weight``) like the reference.
Images NCHW in [-1, 1], logits NCHW [B, classes, h, w], targets [B, h, w]
int.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from ..metrics.image import ms_ssim
from ..utils.registry import LOSS_REGISTRY


def _reduce(x, reduction: str):
    if reduction == "mean":
        return torch.mean(x)
    if reduction == "sum":
        return torch.sum(x)
    return x


def _nll(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(log p of the target class, per position) over logits [B, n, h, w]."""
    logp = F.log_softmax(logits, dim=1)
    return torch.gather(logp, 1, target.long()[:, None])[:, 0]


@LOSS_REGISTRY.register()
@dataclasses.dataclass(frozen=True)
class RateLoss:
    loss_weight: float
    target_rate: float = 0.0
    reduction: str = "mean"

    def __call__(self, bpp, **kw):
        return self.loss_weight * _reduce(bpp, self.reduction)


@LOSS_REGISTRY.register()
@dataclasses.dataclass(frozen=True)
class MSELoss:
    """Range-normalized MSE: alpha 1 with normalize_img (images mapped to
    the chosen range first), else the reference's fixed alphas."""
    loss_weight: float
    normalize_img: bool = False
    mse_scale: str = "0_255"

    def __call__(self, real_images, fake_images, **kw):
        if self.normalize_img:
            if self.mse_scale == "0_255":
                real_images = (real_images + 1.0) / 2.0 * 255.0
                fake_images = (fake_images + 1.0) / 2.0 * 255.0
            else:
                real_images = (real_images + 1.0) / 2.0
                fake_images = (fake_images + 1.0) / 2.0
            alpha = 1.0
        else:
            alpha = (255.0 ** 2) / 4000.0 if self.mse_scale == "0_255" else 0.25
        return self.loss_weight * alpha * torch.mean((real_images - fake_images) ** 2)


@LOSS_REGISTRY.register()
@dataclasses.dataclass(frozen=True)
class VanillaMSELoss:
    loss_weight: float
    reduction: str = "mean"

    def __call__(self, real_feat, fake_feat, **kw):
        return self.loss_weight * _reduce((real_feat - fake_feat) ** 2, self.reduction)


@LOSS_REGISTRY.register()
@dataclasses.dataclass(frozen=True)
class L1Loss:
    loss_weight: float

    def __call__(self, real_images, fake_images, **kw):
        return self.loss_weight * torch.mean(torch.abs(real_images - fake_images))


@LOSS_REGISTRY.register()
@dataclasses.dataclass(frozen=True)
class MSSSIMLoss:
    loss_weight: float

    def __call__(self, real_images, fake_images, **kw):
        a = (real_images + 1.0) / 2.0
        b = (fake_images + 1.0) / 2.0
        return self.loss_weight * (1.0 - torch.mean(ms_ssim(a, b)))


@LOSS_REGISTRY.register()
@dataclasses.dataclass(frozen=True)
class CrossEntropyLoss:
    loss_weight: float

    def __call__(self, logits, target, **kw):
        return self.loss_weight * torch.mean(-_nll(logits, target))


@LOSS_REGISTRY.register()
@dataclasses.dataclass(frozen=True)
class FocalCrossEntropyLoss:
    loss_weight: float
    gamma: float = 2.0
    reduction: str = "mean"

    def __call__(self, logits, target, **kw):
        logpt = _nll(logits, target)
        focal = ((1.0 - torch.exp(logpt)) ** self.gamma) * (-logpt)
        return self.loss_weight * _reduce(focal, self.reduction)


@LOSS_REGISTRY.register()
@dataclasses.dataclass(frozen=True)
class VanillaGANLoss:
    """BCE-with-logits adversarial loss; the discriminator's loss is
    returned unweighted."""
    loss_weight: float
    real_label: float = 1.0
    fake_label: float = 0.0

    def __call__(self, x, is_real: bool, is_disc: bool = False, **kw):
        label = self.real_label if is_real else self.fake_label
        loss = torch.mean(torch.clamp(x, min=0) - x * label
                          + torch.log1p(torch.exp(-torch.abs(x))))
        return loss if is_disc else self.loss_weight * loss


@LOSS_REGISTRY.register()
@dataclasses.dataclass(frozen=True)
class HingeGANLoss:
    loss_weight: float

    def __call__(self, x, is_real: bool, is_disc: bool = False, **kw):
        if is_disc:
            return torch.mean(F.relu(1.0 - x) if is_real else F.relu(1.0 + x))
        if not is_real:
            raise ValueError("the generator's hinge loss takes is_real=True")
        return self.loss_weight * (-torch.mean(x))


@LOSS_REGISTRY.register()
@dataclasses.dataclass(frozen=True)
class OasisGANLoss:
    """Per-pixel (n_embed + 1)-class cross entropy keyed on the target token
    map; class 0 is "fake"."""
    loss_weight: float

    def __call__(self, logits, target, is_disc: bool, is_real: bool, **kw):
        """logits [B, n_embed + 1, h, w]; target [B, h, w] int tokens."""
        tgt = target.long() + 1 if is_real else torch.zeros_like(target, dtype=torch.long)
        loss = torch.mean(-_nll(logits, tgt))
        return loss if is_disc else self.loss_weight * loss


@LOSS_REGISTRY.register()
@dataclasses.dataclass(frozen=True)
class LPIPSLoss:
    """Perceptual loss: LPIPS through ``lpips_fn`` when its weights were
    loaded (``metrics/feature_nets.py::load_lpips``), else the multi-scale
    gradient-L1 proxy ``_laplacian_l1`` (the JAX package's own fallback when
    no weights are configured)."""
    loss_weight: float
    net: str = "alex"
    range_norm: bool = False

    def __call__(self, real_images, fake_images, lpips_fn=None, **kw):
        if self.range_norm:
            real_images = (real_images - 0.5) * 2.0
            fake_images = (fake_images - 0.5) * 2.0
        if lpips_fn is not None:
            return self.loss_weight * torch.mean(lpips_fn(real_images, fake_images))
        return self.loss_weight * _laplacian_l1(real_images, fake_images)


def _laplacian_l1(a, b, levels: int = 3):
    """Edge-aware multi-scale L1 of the vertical and horizontal differences
    (circular), over ``levels`` 2x average-pooled scales."""
    total = 0.0
    for _ in range(levels):
        da = a - torch.roll(a, 1, dims=2)
        db = b - torch.roll(b, 1, dims=2)
        ra = a - torch.roll(a, 1, dims=3)
        rb = b - torch.roll(b, 1, dims=3)
        total = total + torch.mean(torch.abs(da - db)) + torch.mean(torch.abs(ra - rb))
        a = F.avg_pool2d(a, 2, 2)
        b = F.avg_pool2d(b, 2, 2)
    return total


def build_loss(opt: Dict):
    """Config subtree -> loss callable."""
    cfg = dict(opt)
    loss_type = cfg.pop("type")
    cfg.pop("ce_kwargs", None)
    return LOSS_REGISTRY.get(loss_type)(**cfg)
