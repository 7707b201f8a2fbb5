"""Building blocks of the DCVICModel family and the alternative transforms
(port of dc_vic_tpu/nn/layers.py).

NCHW modules whose parameter names are the reference's torch keys. Convs use
torch's symmetric padding k//2, which is what the JAX package's explicit
padding reproduces; the JAX ``DeconvTorch`` is ``nn.ConvTranspose2d`` with
kernel 5, stride 2, padding 2 and output_padding 1.

Reconstruction kernels. ``GroupNorm`` and ``Conv2d`` each carry a
``recon_kernel`` flag, off by default and set by ``build_comp_model``'s
``recon_kernels`` argument (the JAX package's DCVIC_GN=pallas and
DCVIC_PALLAS_CONV=1). With the flag on, a forward whose input shape passes
the kernel's shape rule goes through ``ops/gn.py`` (kernels K3 and K4) or
``ops/conv3x3.py`` (K5); any other shape takes the module's ordinary
PyTorch code, as the JAX package routes it to XLA.

Compute dtype. A layer computes in the dtype of its own weight: it casts its
input to that dtype, as a flax layer built with ``dtype=`` casts input,
kernel and bias at use. ``build_comp_model`` rounds the conv and dense
weights of the bf16 stacks to bf16 once (``codec_dtype: bfloat16``), which is
the same arithmetic as casting f32 parameters at every call. GroupNorm keeps
f32 parameters and f32 arithmetic and returns its input's dtype; residual
sums and FiLM products promote as the JAX package's do (f32 with bf16 gives
f32), so an f32 input stays f32 until the next conv takes it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3 as conv3x3_ops
from ..ops import gn as gn_ops
from ..utils.profiling import span


def num_groups32(channels: int) -> int:
    """GroupNorm group count: 32, or gcd(32, C) for narrow test widths."""
    return 32 if channels % 32 == 0 else math.gcd(32, channels)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters, same default forward) whose 3x3
    stride-1 forward takes kernel K5 when ``recon_kernel`` is on and the
    shape passes ``ops.conv3x3.use_kernel``; the bias is added after the
    kernel, as the JAX package's PallasConv3 adds it."""

    recon_kernel = False

    def takes_kernel(self, shape) -> bool:
        """Whether a forward on an input of ``shape`` goes through K5."""
        B, C, H, W = shape
        return (self.recon_kernel and self.kernel_size == (3, 3)
                and self.stride == (1, 1) and self.padding == (1, 1)
                and self.dilation == (1, 1) and self.groups == 1
                and conv3x3_ops.use_kernel(B, C, self.out_channels, H, W))

    def forward(self, x):
        x = x.to(self.weight.dtype)
        if not self.takes_kernel(x.shape):
            return super().forward(x)
        y = conv3x3_ops.conv3x3_same(x, self.weight)
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        return y


def conv(cin: int, cout: int, k: int = 3, stride: int = 1,
         entropy: bool = False) -> nn.Conv2d:
    """A conv with torch's symmetric padding. ``entropy=True`` marks a conv
    whose output decides rANS indexes (hyperdecoder, ChARM transforms; the
    JAX package's ``precision='high'`` convs): it is a plain ``nn.Conv2d``
    that no reconstruction kernel can ever take."""
    cls = nn.Conv2d if entropy else Conv2d
    return cls(cin, cout, k, stride=stride, padding=(k - 1) // 2)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` computing in its weight's dtype."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


def deconv(cin: int, cout: int, k: int = 5) -> ConvTranspose2d:
    """ConvTranspose2d(k, stride 2, padding (k-1)//2, output_padding 1):
    doubles the spatial size."""
    return ConvTranspose2d(cin, cout, k, stride=2, padding=(k - 1) // 2,
                           output_padding=1)


def pixel_shuffle_up(cin: int, cout: int, k: int = 5) -> nn.Sequential:
    """A conv to 4 * cout channels, then depth-to-space x2 (the JAX
    package's PixelShuffleUp, whose reshape is torch's channel order
    c * 4 + i * 2 + j)."""
    return nn.Sequential(conv(cin, 4 * cout, k), nn.PixelShuffle(2))


def up_conv(cin: int, cout: int, pixel_shuffle: bool) -> nn.Module:
    """The ELIC decoders' x2 upsampling: a 5x5 pixel-shuffle conv or a 5x5
    transposed conv."""
    return pixel_shuffle_up(cin, cout, 5) if pixel_shuffle else deconv(cin, cout, 5)


def activation(act: str) -> nn.Module:
    """The GNResBlock activations: swish/silu, leakyrelu (slope 0.2, not
    PyTorch's 0.01), gelu (flax's default, the tanh approximation) and
    relu."""
    if act in ("swish", "silu"):
        return nn.SiLU()
    if act == "leakyrelu":
        return nn.LeakyReLU(0.2)
    if act == "gelu":
        return nn.GELU(approximate="tanh")
    if act == "relu":
        return nn.ReLU()
    raise ValueError(f"activation {act!r}: swish, silu, leakyrelu, gelu or relu")


class PointwiseLinear(nn.Linear):
    """A Dense layer over the channel axis of an NCHW map (a 1x1 conv whose
    weight is stored 2-D, as the JAX package exports it)."""

    def forward(self, x):
        return F.conv2d(x.to(self.weight.dtype), self.weight[:, :, None, None], self.bias)


class GroupNorm(nn.Module):
    """GroupNorm with the JAX package's statistics: f32 per-(image, group)
    mean and the fast variance E[x^2] - E[x]^2 clipped at zero
    (dc_vic_tpu/ops/gn.py), folded into a per-(image, channel) affine, with
    an optional fused swish. With ``recon_kernel`` on, a 4-D input that
    passes ``ops.gn.use_kernel`` takes the same computation through kernels
    K3 and K4."""

    recon_kernel = False

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def takes_kernel(self, shape) -> bool:
        """Whether a forward on an input of ``shape`` goes through K3/K4."""
        return self.recon_kernel and gn_ops.use_kernel(shape)

    def forward(self, x):
        with span("nn.group_norm"):
            if self.takes_kernel(x.shape):
                return gn_ops.group_norm(x, self.weight, self.bias, self.num_groups,
                                         self.eps, self.act)
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
    that every FiLM layer reads (DualBetaCondMLP). The Fourier features are
    f32; the MLP computes in its weights' dtype."""
    e1 = fourier_encode_beta(beta_1, L, max_beta_1, use_pi, include_x)
    e2 = fourier_encode_beta(beta_2, L, max_beta_2, use_pi, include_x)
    return mlp(torch.cat([e1, e2], dim=-1).to(mlp[0].weight.dtype))


class BetaScaleShift(nn.Module):
    """FiLM: feat * (1 + scale(cond)) + shift(cond), cond broadcast over H, W."""

    def __init__(self, feat_ch: int, cond_ch: int):
        super().__init__()
        self.shared = nn.Sequential(nn.Linear(cond_ch, cond_ch), nn.ReLU())
        self.scale = nn.Linear(cond_ch, feat_ch)
        self.shift = nn.Linear(cond_ch, feat_ch)

    def forward(self, feat, cond):
        with span("nn.fusion"):
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
    def __init__(self, ch: int, act: Optional[str] = "swish"):
        super().__init__()
        self.norm = GroupNorm(num_groups32(ch), ch, act=act)

    def forward(self, x):
        return self.norm(x)


class FemasrResBlock(nn.Module):
    """The same block with femasr naming (the VQ estimator):
    conv = [norm, act, conv, norm, act, conv]. Positions 1 and 4 hold no
    parameters: a swish (``act`` "swish" or "silu") is fused into the norms
    and they are identities, any other ``activation`` sits there."""

    def __init__(self, ch: int, act: str = "swish"):
        super().__init__()
        fused = act in ("swish", "silu")
        norm = lambda: _NormLayer(ch, "swish" if fused else None)
        act_layer = lambda: nn.Identity() if fused else activation(act)
        self.conv = nn.Sequential(norm(), act_layer(), conv(ch, ch, 3),
                                  norm(), act_layer(), conv(ch, ch, 3))

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
        with span("nn.fusion"):
            fuse = self.fuse_block(torch.cat([cond_feat, dec_feat], dim=1))
            return dec_feat + w * (dec_feat * self.scale(fuse) + self.shift(fuse))


class LightFuseSftBlock(nn.Module):
    """The lighter SFT fusion: dec + w * (dec * scale(f) + shift(f)) with
    f = the 1x1 and 3x3 ``fuse_block`` (leaky ReLU 0.2 after each) on
    concat(cond, dec) in place of the GroupNorm ResBlock, and one 3x3 conv
    each for scale and shift."""

    def __init__(self, dec_ch: int, cond_ch: int, mid_ch: int):
        super().__init__()
        self.fuse_block = nn.Sequential(conv(cond_ch + dec_ch, mid_ch, 1), nn.LeakyReLU(0.2),
                                        conv(mid_ch, mid_ch, 3), nn.LeakyReLU(0.2))
        self.scale = conv(mid_ch, dec_ch, 3)
        self.shift = conv(mid_ch, dec_ch, 3)

    def forward(self, dec_feat, cond_feat, w: float = 1.0):
        with span("nn.fusion"):
            fuse = self.fuse_block(torch.cat([cond_feat, dec_feat], dim=1))
            return dec_feat + w * (dec_feat * self.scale(fuse) + self.shift(fuse))


class GDN(nn.Module):
    """Generalized divisive normalization, y_i = x_i / sqrt(beta_i + sum_j
    gamma[i, j] * x_j^2) (``inverse``: times the root), plain PyTorch as the
    JAX package's is plain JAX. ``beta`` and ``gamma`` are stored through
    the sqrt reparameterization with a pedestal, in compressai's layout:
    ``gamma`` [out, in] is the 1x1 conv's weight, the transpose of the JAX
    package's ``gamma_raw`` (its einsum sums ``gamma_raw[j, i]``). Init
    (``reset_parameters``) is deterministic: sqrt(1 + pedestal) and
    sqrt(gamma_init * I + pedestal)."""

    PEDESTAL = 2.0 ** -18

    def __init__(self, ch: int, inverse: bool = False, beta_min: float = 1e-6,
                 gamma_init: float = 0.1):
        super().__init__()
        self.inverse = inverse
        self.gamma_init = gamma_init
        self.beta_bound = (beta_min + self.PEDESTAL) ** 0.5
        self.gamma_bound = self.PEDESTAL ** 0.5
        self.beta = nn.Parameter(torch.empty(ch))
        self.gamma = nn.Parameter(torch.empty(ch, ch))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        ch = self.beta.numel()
        self.beta.copy_(torch.sqrt(torch.ones(ch) + self.PEDESTAL))
        self.gamma.copy_(torch.sqrt(self.gamma_init * torch.eye(ch) + self.PEDESTAL))

    def forward(self, x):
        beta = torch.clamp(self.beta, min=self.beta_bound) ** 2 - self.PEDESTAL
        gamma = torch.clamp(self.gamma, min=self.gamma_bound) ** 2 - self.PEDESTAL
        norm = torch.sqrt(F.conv2d(torch.square(x).to(gamma.dtype),
                                   gamma[:, :, None, None], beta))
        return x * norm if self.inverse else x / norm
