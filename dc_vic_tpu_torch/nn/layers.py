"""Building blocks of the flagship model (port of the subset of
dc_vic_tpu/nn/layers.py that config/dc_vic_patchgan.yaml uses).

NCHW modules whose parameter names are the reference's torch keys. Convs use
torch's symmetric padding k//2, which is what the JAX package's explicit
padding reproduces; the JAX ``DeconvTorch`` is ``nn.ConvTranspose2d`` with
kernel 5, stride 2, padding 2 and output_padding 1.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def num_groups32(channels: int) -> int:
    """GroupNorm group count: 32, or gcd(32, C) for narrow test widths."""
    return 32 if channels % 32 == 0 else math.gcd(32, channels)


def conv(cin: int, cout: int, k: int = 3, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2)


def deconv(cin: int, cout: int, k: int = 5) -> nn.ConvTranspose2d:
    """ConvTranspose2d(k, stride 2, padding (k-1)//2, output_padding 1):
    doubles the spatial size."""
    return nn.ConvTranspose2d(cin, cout, k, stride=2, padding=(k - 1) // 2,
                              output_padding=1)


class PointwiseLinear(nn.Linear):
    """A Dense layer over the channel axis of an NCHW map (a 1x1 conv whose
    weight is stored 2-D, as the JAX package exports it)."""

    def forward(self, x):
        return F.conv2d(x, self.weight[:, :, None, None], self.bias)


class GroupNorm(nn.Module):
    """GroupNorm with the JAX package's statistics: f32 per-(image, group)
    mean and the fast variance E[x^2] - E[x]^2 clipped at zero
    (dc_vic_tpu/ops/gn.py), folded into a per-(image, channel) affine, with
    an optional fused swish."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        B, C = x.shape[:2]
        G = self.num_groups
        xg = x.float().reshape(B, G, -1)
        mean = xg.mean(-1)
        var = torch.clamp((xg * xg).mean(-1) - mean * mean, min=0.0)
        inv = torch.rsqrt(var + self.eps)
        rep = lambda a: a.repeat_interleave(C // G, dim=1)     # [B,G]->[B,C]
        scale = self.weight.float()[None] * rep(inv)
        shift = self.bias.float()[None] - rep(mean) * scale
        y = x.float() * scale[:, :, None, None] + shift[:, :, None, None]
        if self.act == "swish":
            y = y * torch.sigmoid(y)
        return y.to(x.dtype)


class BottleneckResBlock(nn.Module):
    """1x1 -> relu -> 3x3 -> relu -> 1x1 residual block (ELIC)."""

    def __init__(self, ch: int, mid_ch: int):
        super().__init__()
        self.conv = nn.Sequential(conv(ch, mid_ch, 1), nn.ReLU(),
                                  conv(mid_ch, mid_ch, 3), nn.ReLU(),
                                  conv(mid_ch, ch, 1))

    def forward(self, x):
        return x + self.conv(x)


class ResidualBottleneckBlocks(nn.Module):
    def __init__(self, ch: int, mid_ch: int, num_blocks: int = 3,
                 res_in_res: bool = False):
        super().__init__()
        self.num_blocks = num_blocks
        self.res_in_res = res_in_res
        for i in range(num_blocks):
            self.add_module(f"block{i}", BottleneckResBlock(ch, mid_ch))

    def forward(self, x):
        y = x
        for i in range(self.num_blocks):
            y = getattr(self, f"block{i}")(y)
        return x + y if self.res_in_res else y


class NLAMResBlock(nn.Module):
    """Half-width 1x1/3x3/1x1 residual block inside NLAM."""

    def __init__(self, ch: int):
        super().__init__()
        mid = ch // 2
        self.c1 = conv(ch, mid, 1)
        self.c2 = conv(mid, mid, 3)
        self.c3 = conv(mid, ch, 1)

    def forward(self, x):
        y = F.relu(self.c1(x))
        y = F.relu(self.c2(y))
        return x + self.c3(y)


class ChengNLAM(nn.Module):
    """x + trunk(x) * sigmoid(conv(attn(x))) (Cheng CVPR 2020)."""

    def __init__(self, ch: int):
        super().__init__()
        self.trunk_block = nn.ModuleList(NLAMResBlock(ch) for _ in range(3))
        self.attention_block = nn.ModuleList(NLAMResBlock(ch) for _ in range(3))
        self.conv = conv(ch, ch, 1)

    def forward(self, x):
        trunk = x
        for blk in self.trunk_block:
            trunk = blk(trunk)
        attn = x
        for blk in self.attention_block:
            attn = blk(attn)
        return x + trunk * torch.sigmoid(self.conv(attn))


def fourier_encode_beta(beta: torch.Tensor, L: int, max_beta: float,
                        use_pi: bool = False, include_x: bool = True) -> torch.Tensor:
    """Fourier features [B, 2L(+1)] of a conditioning scalar beta [B]."""
    beta = beta.float().reshape(-1)
    nb = (beta / max_beta - 0.5) * 2.0
    freq = 2.0 ** torch.arange(L, dtype=torch.float32, device=beta.device)
    if use_pi:
        freq = freq * math.pi
    ang = nb[:, None] * freq[None, :]
    out = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if include_x:
        out = torch.cat([nb[:, None], out], dim=-1)
    return out


def beta_mlp(cond_ch: int, L: int, include_x: bool) -> nn.Sequential:
    """The dual-beta conditioning MLP (reference key ``mlp.{0,2}``)."""
    n_in = 2 * (2 * L + (1 if include_x else 0))
    return nn.Sequential(nn.Linear(n_in, cond_ch), nn.ReLU(),
                         nn.Linear(cond_ch, cond_ch))


def beta_cond(mlp: nn.Sequential, beta_1, beta_2, L: int, max_beta_1: float,
              max_beta_2: float, use_pi: bool, include_x: bool) -> torch.Tensor:
    """Fourier(beta_1) ++ Fourier(beta_2) -> MLP: the cond vector [B, cond_ch]
    that every FiLM layer reads (DualBetaCondMLP)."""
    e1 = fourier_encode_beta(beta_1, L, max_beta_1, use_pi, include_x)
    e2 = fourier_encode_beta(beta_2, L, max_beta_2, use_pi, include_x)
    return mlp(torch.cat([e1, e2], dim=-1))


class BetaScaleShift(nn.Module):
    """FiLM: feat * (1 + scale(cond)) + shift(cond), cond broadcast over H, W."""

    def __init__(self, feat_ch: int, cond_ch: int):
        super().__init__()
        self.shared = nn.Sequential(nn.Linear(cond_ch, cond_ch), nn.ReLU())
        self.scale = nn.Linear(cond_ch, feat_ch)
        self.shift = nn.Linear(cond_ch, feat_ch)

    def forward(self, feat, cond):
        h = self.shared(cond)
        scale = self.scale(h)[:, :, None, None]
        shift = self.shift(h)[:, :, None, None]
        return feat * (1.0 + scale) + shift


class GNResBlock(nn.Module):
    """Pre-activation GroupNorm residual block, codeformer naming (the SFT
    fusion trunk): norm1, conv1, norm2, conv2, conv_out."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(num_groups32(in_ch), in_ch, act="swish")
        self.conv1 = conv(in_ch, out_ch, 3)
        self.norm2 = GroupNorm(num_groups32(out_ch), out_ch, act="swish")
        self.conv2 = conv(out_ch, out_ch, 3)
        self.conv_out = conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if self.conv_out is not None:
            x = self.conv_out(x)
        return x + h


class _NormLayer(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.norm = GroupNorm(num_groups32(ch), ch, act="swish")

    def forward(self, x):
        return self.norm(x)


class FemasrResBlock(nn.Module):
    """The same block with femasr naming (the VQ estimator):
    conv = [norm, act, conv, norm, act, conv]; the swish is fused into the
    norms, so positions 1 and 4 hold no parameters."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Sequential(_NormLayer(ch), nn.Identity(), conv(ch, ch, 3),
                                  _NormLayer(ch), nn.Identity(), conv(ch, ch, 3))

    def forward(self, x):
        return x + self.conv(x)


class FuseSftBlock(nn.Module):
    """SFT fusion: dec + w * (dec * scale(f) + shift(f)),
    f = GNResBlock(concat(cond, dec))."""

    def __init__(self, dec_ch: int, cond_ch: int, mid_ch: int):
        super().__init__()
        self.fuse_block = GNResBlock(cond_ch + dec_ch, mid_ch)
        self.scale = nn.Sequential(conv(mid_ch, dec_ch, 3), nn.LeakyReLU(0.2),
                                   conv(dec_ch, dec_ch, 3))
        self.shift = nn.Sequential(conv(mid_ch, dec_ch, 3), nn.LeakyReLU(0.2),
                                   conv(dec_ch, dec_ch, 3))

    def forward(self, dec_feat, cond_feat, w: float = 1.0):
        fuse = self.fuse_block(torch.cat([cond_feat, dec_feat], dim=1))
        return dec_feat + w * (dec_feat * self.scale(fuse) + self.shift(fuse))
