"""Perceptual feature networks: AlexNet and VGG16 feature taps, LPIPS and
DISTS (port of dc_vic_tpu/metrics/feature_nets.py).

The backbones are laid out as torchvision's ``features`` Sequentials, so a
torchvision-layout state dict loads by name. Pretrained weights are not in
the repository; ``load_lpips`` and ``load_dists`` read a ``torch.save``d
state dict under exactly the keys the JAX package's converters read, and
return None without a path (callers then skip the metric, or the LPIPS loss
takes its gradient-L1 proxy).

The networks compute in f32 with TF32 off, scoped to each call
(``utils/backends.py::backend_flags``), so card values follow the CPU's.
DISTS is the JAX package's: VGG16 with its max pools (the published DISTS
pools with an L2 filter).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from ..utils.backends import backend_flags

# lpips package input normalization (images in [-1, 1])
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)
# ImageNet normalization of DISTS's VGG input (images in [0, 1])
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _channels(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=like.dtype, device=like.device).view(1, -1, 1, 1)


def lpips_normalize(x: torch.Tensor) -> torch.Tensor:
    """NCHW images in [-1, 1] -> the LPIPS backbones' input."""
    return (x - _channels(_LPIPS_SHIFT, x)) / _channels(_LPIPS_SCALE, x)


class _Taps(nn.Module):
    """A torchvision ``features`` Sequential that returns the outputs of the
    ReLUs at ``TAPS``."""
    TAPS: Sequence[int] = ()

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features[:self.TAPS[-1] + 1]):
            x = layer(x)
            if i in self.TAPS:
                taps.append(x)
        return taps


class AlexNetFeatures(_Taps):
    """torchvision AlexNet.features (convs at 0, 3, 6, 8, 10; max pools 3/2
    without padding), returning the 5 relu taps LPIPS uses."""
    CONVS = (0, 3, 6, 8, 10)
    TAPS = (1, 4, 7, 9, 11)
    CHANNELS = (64, 192, 384, 256, 256)

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2d(3, 2))


class VGG16Features(_Taps):
    """torchvision VGG16.features (convs at 0, 2, 5, ..., 28; max pools
    2/2), returning the 5 relu taps LPIPS and DISTS use (relu1_2, relu2_2,
    relu3_3, relu4_3, relu5_3)."""
    CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
    CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
    TAPS = (3, 8, 15, 22, 29)
    CHANNELS = (64, 128, 256, 512, 512)

    def __init__(self):
        super().__init__()
        layers, in_ch = [], 3
        for ch, reps in self.CFG:
            for _ in range(reps):
                layers += [nn.Conv2d(in_ch, ch, 3, padding=1), nn.ReLU()]
                in_ch = ch
            layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)


def _backbone(net: str) -> _Taps:
    if net == "alex":
        return AlexNetFeatures()
    if net == "vgg":
        return VGG16Features()
    raise ValueError(f"LPIPS net {net!r}: expected 'alex' or 'vgg'")


class LPIPS(nn.Module):
    """Learned perceptual metric: unit-normalized feature differences, 1x1
    calibration heads (|w|), spatial mean, stage sum. ``net`` in {'alex',
    'vgg'}; the heads ``lin{i}`` hold one weight per channel."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        self.net = _backbone(net)
        for i, c in enumerate(self.net.CHANNELS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(c)))

    def forward(self, a, b) -> torch.Tensor:
        """a, b: NCHW in [-1, 1]. Returns per-image LPIPS [B]."""
        with backend_flags(allow_tf32=False):
            fa = self.net(lpips_normalize(a.float()))
            fb = self.net(lpips_normalize(b.float()))
            total = 0.0
            for i, (xa, xb) in enumerate(zip(fa, fb)):
                na = xa * torch.rsqrt(torch.sum(xa ** 2, 1, keepdim=True) + 1e-10)
                nb = xb * torch.rsqrt(torch.sum(xb ** 2, 1, keepdim=True) + 1e-10)
                w = torch.abs(getattr(self, f"lin{i}")).view(1, -1, 1, 1)
                total = total + torch.mean(torch.sum((na - nb) ** 2 * w, dim=1), dim=(1, 2))
            return total


class DISTS(nn.Module):
    """Deep Image Structure and Texture Similarity (Ding et al. 2020) as
    the JAX package computes it: the image itself and the five VGG16 taps;
    per-channel weights ``alpha`` (texture: means) and ``beta`` (structure:
    correlations), flat over all 3 + 1472 channels."""
    C1 = C2 = 1e-6

    def __init__(self):
        super().__init__()
        self.vgg16 = VGG16Features()
        n = 3 + sum(VGG16Features.CHANNELS)
        self.alpha = nn.Parameter(torch.ones(n))
        self.beta = nn.Parameter(torch.ones(n))

    def forward(self, a, b) -> torch.Tensor:
        """a, b: NCHW in [0, 1]. Returns the per-image distance [B]."""
        with backend_flags(allow_tf32=False):
            a, b = a.float(), b.float()
            mean, std = _channels(_IMAGENET_MEAN, a), _channels(_IMAGENET_STD, a)
            fa = [a] + self.vgg16((a - mean) / std)
            fb = [b] + self.vgg16((b - mean) / std)
            w_sum = torch.sum(self.alpha) + torch.sum(self.beta)
            sim, off = 0.0, 0
            for xa, xb in zip(fa, fb):
                C = xa.shape[1]
                a_w = self.alpha[off:off + C] / w_sum
                b_w = self.beta[off:off + C] / w_sum
                off += C
                mu_a, mu_b = torch.mean(xa, dim=(2, 3)), torch.mean(xb, dim=(2, 3))
                var_a = torch.var(xa, dim=(2, 3), unbiased=False)
                var_b = torch.var(xb, dim=(2, 3), unbiased=False)
                cov = torch.mean(xa * xb, dim=(2, 3)) - mu_a * mu_b
                s1 = (2 * mu_a * mu_b + self.C1) / (mu_a ** 2 + mu_b ** 2 + self.C1)
                s2 = (2 * cov + self.C2) / (var_a + var_b + self.C2)
                sim = sim + torch.sum(a_w * s1 + b_w * s2, dim=-1)
            return 1.0 - sim


# --------------------------------------------------------------------------
# state-dict loaders (the keys of the JAX package's converters)
# --------------------------------------------------------------------------

def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``torch.save``d state dict, on the CPU (tensors only: nothing else
    in the file is unpickled)."""
    return dict(torch.load(path, map_location="cpu", weights_only=True))


def _find(sd, keys):
    for k in keys:
        if k in sd:
            return sd[k]
    raise KeyError(f"none of {keys} in state dict")


def _backbone_state(backbone: _Taps, sd, prefixes) -> Dict[str, torch.Tensor]:
    """The backbone's conv weights and biases from ``{prefix}.{index}.*``,
    the first prefix that holds each."""
    out = {}
    for s in backbone.CONVS:
        for leaf in ("weight", "bias"):
            out[f"features.{s}.{leaf}"] = _find(sd, [f"{p}.{s}.{leaf}" for p in prefixes])
    return out


def _frozen(module: nn.Module, device) -> nn.Module:
    module = module.to(device).eval()
    for p in module.parameters():
        p.requires_grad_(False)
    return module


def lpips_from_state_dict(sd, net: str = "alex", device="cuda") -> LPIPS:
    """LPIPS with the backbone from ``net.features.{s}`` (or, for alex,
    ``features.{s}``) and the heads from ``lin{i}.model.1.weight`` (or, for
    alex, ``lins.{i}.model.1.weight``), frozen on ``device``."""
    model = LPIPS(net)
    if net == "alex":
        prefixes, heads = ("net.features", "features"), ("lin{}.model.1.weight",
                                                         "lins.{}.model.1.weight")
    else:
        prefixes, heads = ("net.features",), ("lin{}.model.1.weight",)
    state = {f"net.{k}": v for k, v in _backbone_state(model.net, sd, prefixes).items()}
    for i in range(len(model.net.CHANNELS)):
        state[f"lin{i}"] = _find(sd, [h.format(i) for h in heads]).reshape(-1)
    model.load_state_dict(state, strict=True)
    return _frozen(model, device)


def dists_from_state_dict(sd, device="cuda") -> DISTS:
    """DISTS with the backbone from ``vgg16.features.{s}`` when the state
    dict has ``vgg16.*`` keys, else ``features.{s}``, and the flat
    ``alpha`` and ``beta``, frozen on ``device``."""
    model = DISTS()
    prefix = "vgg16.features" if any(k.startswith("vgg16") for k in sd) else "features"
    state = {f"vgg16.{k}": v for k, v in _backbone_state(model.vgg16, sd, (prefix,)).items()}
    state["alpha"] = sd["alpha"].reshape(-1)
    state["beta"] = sd["beta"].reshape(-1)
    model.load_state_dict(state, strict=True)
    return _frozen(model, device)


def load_lpips(weights_path: Optional[str], net: str = "alex", device="cuda"):
    """The frozen LPIPS module ((a, b) NCHW in [-1, 1] -> [B]) on
    ``device``, or None without ``weights_path``. Gradients flow to its
    inputs, never to its parameters."""
    if not weights_path:
        return None
    return lpips_from_state_dict(read_state_dict(weights_path), net, device)


def load_dists(weights_path: Optional[str], device="cuda"):
    """The frozen DISTS module ((a, b) NCHW in [0, 1] -> [B]) on
    ``device``, or None without ``weights_path``."""
    if not weights_path:
        return None
    return dists_from_state_dict(read_state_dict(weights_path), device)
