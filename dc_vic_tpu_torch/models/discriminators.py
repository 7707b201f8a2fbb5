"""Discriminators of the GAN stages (port of
dc_vic_tpu/models/discriminators.py).

The PatchGAN (pix2pix NLayer) trunk with a selectable normalization, and the
dual-beta conditioned variant the shipped stage configs use: Fourier features
of (beta_rate, beta_vq) through a two-layer MLP give a conditioning vector,
broadcast over H and W and concatenated to the image channels, with an
optional y_hat branch. Two more variants: the FiLM one, which scales and
shifts every inner layer by that vector instead, and the OASIS one, the
dual-beta trunk with a per-pixel (n_embed + 1)-class head on the VQ token
grid. NCHW modules; ``models/convert.py::discriminator_state_dict`` maps the
JAX package's parameters onto them. A conditioned discriminator's forward
is the program span ``nn.discriminator``, once a call.
"""
from __future__ import annotations

import inspect
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BetaScaleShift, beta_cond, beta_mlp, fourier_encode_beta, num_groups32
from ..utils.profiling import span
from ..utils.registry import DISCRIMINATOR_REGISTRY


class _ActNorm(nn.Module):
    """Flow-style ActNorm: per-channel loc and scale, set from the first
    batch it sees so that batch comes out zero-mean and unit-variance (a
    constant batch leaves the identity)."""

    def __init__(self, ch: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(ch))
        self.scale = nn.Parameter(torch.ones(ch))
        self.register_buffer("initialized", torch.zeros((), dtype=torch.bool))

    @torch.no_grad()
    def _initialize(self, x):
        flat = x.transpose(0, 1).reshape(x.shape[1], -1)
        std = flat.std(dim=1)
        self.scale.copy_(torch.where(std > 1e-12, 1.0 / (std + 1e-6), torch.ones_like(std)))
        self.loc.copy_(-flat.mean(dim=1))
        self.initialized.fill_(True)

    def forward(self, x):
        if not bool(self.initialized):
            self._initialize(x)
        return self.scale[None, :, None, None] * (x + self.loc[None, :, None, None])


class _LayerNorm(nn.Module):
    """LayerNorm over the channels of each position (flax LayerNorm on the
    last axis of an NHWC map)."""

    def __init__(self, ch: int, eps: float = 1e-6):
        super().__init__()
        self.norm = nn.LayerNorm(ch, eps=eps)

    def forward(self, x):
        return self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _InstanceNorm(nn.Module):
    """Per-image, per-channel spatial normalization without an affine."""

    def forward(self, x):
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + 1e-5)


def _Norm(norm_type: str, ch: int) -> nn.Module:
    """The normalization after each inner PatchGAN conv."""
    if norm_type == "none":
        return nn.Identity()
    if norm_type == "batchnorm":
        return nn.BatchNorm2d(ch, eps=1e-5, momentum=0.01)
    if norm_type == "instancenorm":
        return _InstanceNorm()
    if norm_type == "layernorm":
        return _LayerNorm(ch)
    if norm_type == "groupnorm":
        return nn.GroupNorm(num_groups32(ch), ch, eps=1e-6)
    if norm_type == "actnorm":
        return _ActNorm(ch)
    raise NotImplementedError(norm_type)


def trunk_conv_position(i: int) -> int:
    """Index in ``TamingNLayerDiscriminator.main`` of the trunk's i-th conv
    (its norm, where it has one, follows it)."""
    return 0 if i == 0 else 2 + 3 * (i - 1)


@DISCRIMINATOR_REGISTRY.register()
class TamingNLayerDiscriminator(nn.Module):
    """PatchGAN: stride-2 4x4 convs doubling the filters (up to 8 x ndf),
    then two stride-1 convs; out_nc-channel patch logits. ``keep_shape``
    makes the last two convs 3x3 (the spatial size is then kept)."""

    def __init__(self, in_ch: int = 3, ndf: int = 64, out_nc: int = 1, n_layers: int = 3,
                 keep_shape: bool = False, norm_type: str = "batchnorm",
                 weight_init: bool = True):
        super().__init__()
        self.weight_init = weight_init
        use_bias = norm_type != "batchnorm"
        layers = [nn.Conv2d(in_ch, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * nf_prev, ndf * nf, 4, 2, 1, bias=use_bias),
                       _Norm(norm_type, ndf * nf), nn.LeakyReLU(0.2)]
        kw = 3 if keep_shape else 4
        nf_prev, nf = nf, min(2 ** n_layers, 8)
        layers += [nn.Conv2d(ndf * nf_prev, ndf * nf, kw, 1, 1, bias=use_bias),
                   _Norm(norm_type, ndf * nf), nn.LeakyReLU(0.2),
                   nn.Conv2d(ndf * nf, out_nc, kw, 1, 1)]
        self.main = nn.Sequential(*layers)

    def forward(self, x):
        return self.main(x)


@DISCRIMINATOR_REGISTRY.register()
class DualBetaCondTamingNLayerDiscriminator(nn.Module):
    """PatchGAN conditioned on (beta_rate, beta_vq): Fourier + MLP
    conditioning vector, broadcast over H and W and concatenated to the
    input channels; with ``y_hat_cond`` a conv of the detached y_hat,
    nearest-upsampled to the image, joins them."""

    def __init__(self, ndf: int = 64, out_nc: int = 1, n_layers: int = 3,
                 keep_shape: bool = False, norm_type: str = "none",
                 max_beta_1: float = 3.0, max_beta_2: float = 3.5, L: int = 10,
                 cond_ch: int = 8, use_pi: bool = False, include_x: bool = True,
                 y_hat_cond: bool = False, y_hat_out_ch: Optional[int] = None,
                 y_hat_in_ch: Optional[int] = None, weight_init: bool = True,
                 in_ch: int = 3):
        super().__init__()
        self.beta_args = (L, use_pi, include_x)
        self.max_betas = (max_beta_1, max_beta_2)
        self.cond_ch = cond_ch
        self.y_hat_cond = y_hat_cond
        n_in = 2 * (2 * L + (1 if include_x else 0))
        self.cond_mlp = nn.Sequential(nn.Linear(n_in, cond_ch), nn.ReLU(),
                                      nn.Linear(cond_ch, cond_ch))
        trunk_in = in_ch + cond_ch
        if y_hat_cond:
            if not (y_hat_in_ch and y_hat_out_ch):
                raise ValueError("y_hat_cond needs y_hat_in_ch and y_hat_out_ch")
            self.y_hat_conv = nn.Conv2d(y_hat_in_ch, y_hat_out_ch, 3, padding=1)
            trunk_in += y_hat_out_ch
        self.trunk = TamingNLayerDiscriminator(trunk_in, ndf, out_nc, n_layers, keep_shape,
                                               norm_type, weight_init)

    def forward(self, x, beta_1, beta_2, y_hat=None):
        with span("nn.discriminator"):
            return self.logits(x, beta_1, beta_2, y_hat)

    def logits(self, x, beta_1, beta_2, y_hat=None):
        """The forward outside the program span (for a class that wraps
        this one in its own)."""
        B, _, H, W = x.shape
        L, use_pi, include_x = self.beta_args
        e1 = fourier_encode_beta(beta_1, L, self.max_betas[0], use_pi, include_x)
        e2 = fourier_encode_beta(beta_2, L, self.max_betas[1], use_pi, include_x)
        cond = self.cond_mlp(torch.cat([e1, e2], dim=-1))
        cond = cond[:, :, None, None].expand(B, self.cond_ch, H, W)
        h = torch.cat([x, cond.to(x.dtype)], dim=1)
        if self.y_hat_cond:
            if y_hat is None:
                raise ValueError("y_hat_cond: the discriminator needs y_hat")
            y = F.leaky_relu(self.y_hat_conv(y_hat.detach()), 0.2)
            y = y.repeat_interleave(H // y.shape[2], dim=2).repeat_interleave(
                W // y_hat.shape[3], dim=3)
            h = torch.cat([h, y], dim=1)
        return self.trunk(h)


@DISCRIMINATOR_REGISTRY.register()
class DualBetaFtTamingNLayerDiscriminator(nn.Module):
    """PatchGAN conditioned by FiLM: the dual-beta MLP's vector scales and
    shifts the output of every conv but the last (``BetaScaleShift``),
    instead of joining the input channels. Takes ``y_hat`` and ignores it."""

    def __init__(self, ndf: int = 64, out_nc: int = 1, n_layers: int = 3,
                 norm_type: str = "none", max_beta_1: float = 3.0, max_beta_2: float = 3.5,
                 L: int = 10, cond_ch: int = 64, use_pi: bool = False,
                 include_x: bool = True, weight_init: bool = True, in_ch: int = 3):
        super().__init__()
        self.weight_init = weight_init
        self.beta_args = (L, max_beta_1, max_beta_2, use_pi, include_x)
        self.mlp = beta_mlp(cond_ch, L, include_x)
        use_bias = norm_type != "batchnorm"
        widths = [ndf * min(2 ** n, 8) for n in range(n_layers + 1)]
        self.convs = nn.ModuleList(
            [nn.Conv2d(in_ch, ndf, 4, 2, 1)]
            + [nn.Conv2d(widths[n - 1], widths[n], 4, 2, 1, bias=use_bias)
               for n in range(1, n_layers)]
            + [nn.Conv2d(widths[n_layers - 1], widths[n_layers], 4, 1, 1, bias=use_bias),
               nn.Conv2d(widths[n_layers], out_nc, 4, 1, 1)])
        # the norms follow convs 1 .. n_layers; the FiLMs convs 0 .. n_layers
        self.norms = nn.ModuleList(_Norm(norm_type, w) for w in widths[1:])
        self.films = nn.ModuleList(BetaScaleShift(w, cond_ch) for w in widths)

    def forward(self, x, beta_1, beta_2, y_hat=None):
        with span("nn.discriminator"):
            cond = beta_cond(self.mlp, beta_1, beta_2, *self.beta_args)
            h = x
            for i, film in enumerate(self.films):
                h = self.convs[i](h)
                if i:
                    h = self.norms[i - 1](h)
                h = F.leaky_relu(film(h, cond), 0.2)
            return self.convs[-1](h)


@DISCRIMINATOR_REGISTRY.register()
class OasisDualBetaCondTamingNLayerDiscriminator(nn.Module):
    """OASIS (MS-ILLM) per-pixel discriminator: the dual-beta PatchGAN with
    ``keep_shape`` and n_embed + 1 classes (class 0 "fake", class t + 1 the
    VQ token t), its logits resized nearest to the token grid (H and W over
    ``token_stride``). Takes ``y_hat`` and ignores it."""

    def __init__(self, ndf: int = 64, n_embed: int = 256, n_layers: int = 3,
                 norm_type: str = "none", max_beta_1: float = 3.0, max_beta_2: float = 3.5,
                 L: int = 10, cond_ch: int = 8, use_pi: bool = False, include_x: bool = True,
                 token_stride: int = 8, weight_init: bool = True, in_ch: int = 3):
        super().__init__()
        self.token_stride = token_stride
        self.body = DualBetaCondTamingNLayerDiscriminator(
            ndf=ndf, out_nc=n_embed + 1, n_layers=n_layers, keep_shape=True,
            norm_type=norm_type, max_beta_1=max_beta_1, max_beta_2=max_beta_2, L=L,
            cond_ch=cond_ch, use_pi=use_pi, include_x=include_x, weight_init=weight_init,
            in_ch=in_ch)

    def forward(self, x, beta_1, beta_2, y_hat=None):
        with span("nn.discriminator"):
            logits = self.body.logits(x, beta_1, beta_2)
            size = (x.shape[2] // self.token_stride, x.shape[3] // self.token_stride)
            if tuple(logits.shape[2:]) == size:
                return logits
            # "nearest-exact" samples at pixel centres, as jax.image.resize's
            # "nearest" does; "nearest" would pick other rows
            return F.interpolate(logits, size=size, mode="nearest-exact")


@torch.no_grad()
def init_discriminator(disc: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation following the JAX package's: conv weights
    N(0, 0.02) when the discriminator's ``weight_init`` is set (else
    lecun-normal), dense weights lecun-normal (truncated at two standard
    deviations), zero biases, unit norm scales. The generator lives on the
    discriminator's device."""
    def lecun(w, fan_in):
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

    # each class keeps its own flag: the FiLM discriminator has no trunk
    dcgan = all(m.weight_init for m in disc.modules() if hasattr(m, "weight_init"))
    for m in disc.modules():
        if isinstance(m, nn.Conv2d):
            if dcgan:
                nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
            else:
                lecun(m.weight, m.weight[0].numel())
        elif isinstance(m, nn.Linear):
            lecun(m.weight, m.in_features)
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)):
            nn.init.ones_(m.weight)
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.BatchNorm2d, nn.GroupNorm,
                          nn.LayerNorm)) and m.bias is not None:
            nn.init.zeros_(m.bias)


def build_discriminator(opt: Dict, device="cuda") -> nn.Module:
    """Config -> discriminator on ``device`` (weights to be initialised with
    ``init_discriminator`` or loaded)."""
    cfg = dict(opt)
    cls = DISCRIMINATOR_REGISTRY.get(cfg.pop("type"))
    for k in ("input_nc", "use_actnorm", "norm_kwargs"):
        cfg.pop(k, None)
    # the JAX package infers y_hat_in_ch from its input; a config may carry it
    # for a class without a y_hat branch, which takes no such argument here
    if "y_hat_in_ch" not in inspect.signature(cls).parameters:
        cfg.pop("y_hat_in_ch", None)
    with torch.device(device):
        return cls(**cfg)
