"""Frozen VQGAN prior (f8-n256): encoder, quantizer and the decoder with SFT
fusion taps (port of dc_vic_tpu/models/vqgan.py).

NCHW modules named as the latent-diffusion reference names them
(``vq_model.encoder.down.{l}.block.{b}.conv1`` ...). The attention blocks
call kernel K2 and the quantizer kernel K1; a ``VQResnetBlock`` whose
``fused`` flag is on (``build_comp_model``'s ``recon_kernels``) runs as two
calls of the fused conv kernel K6 where the shape rule allows.

Under a bf16 compute dtype the convs and the two dense layers hold bf16
weights; GroupNorm statistics, the folded affine of the fused block, the
attention operands (K2) and the quantizer's input (K1) stay f32.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import GroupNorm, PointwiseLinear, conv, num_groups32
from ..ops import conv3x3 as conv3x3_ops
from ..ops import gn as gn_ops
from ..ops.attention import flash_attention
from ..ops.vq import vq_argmin_nchw
from ..utils.profiling import span


def gn_fold(x: torch.Tensor, norm: GroupNorm):
    """Fold GroupNorm statistics and gamma, beta into one per-(image,
    channel) affine: GN(x) * gamma + beta == x * scale[b] + bias[b]. Both
    [B, C] f32. The variance is the two-pass one, as in the JAX package's
    fused block (its GroupNorm module uses the fast variance); on the card
    one launch of kernel ``gn_fold`` (``ops/gn.py::fold_stats``). The
    GroupNorm's work outside the conv: the program span ``nn.group_norm``."""
    with span("nn.group_norm"):
        return gn_ops.fold_stats(x, norm.weight, norm.bias, norm.num_groups, norm.eps)


class VQResnetBlock(nn.Module):
    """GroupNorm -> swish -> conv, twice, with a 1x1 shortcut on a channel
    change. With ``fused`` on (the JAX package's DCVIC_FUSED_RESBLOCK=1) and
    a shape that passes the conv kernels' rule, the same parameters run as
    two calls of kernel K6: the affine, swish, conv bias and residual add
    happen inside the conv, and only the statistics stay outside."""

    fused = False

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(num_groups32(in_ch), in_ch, act="swish")
        self.conv1 = conv(in_ch, out_ch, 3)
        self.norm2 = GroupNorm(num_groups32(out_ch), out_ch, act="swish")
        self.conv2 = conv(out_ch, out_ch, 3)
        self.nin_shortcut = conv(in_ch, out_ch, 1) if in_ch != out_ch else None

    def takes_fused(self, shape) -> bool:
        """Whether a forward on an input of ``shape`` runs as two K6 calls."""
        B, C, H, W = shape
        return self.fused and conv3x3_ops.use_kernel(B, C, self.conv1.out_channels, H, W)

    def _fused(self, x):
        # x in the convs' dtype; the folded affine and the conv bias are f32
        x = x.to(self.conv1.weight.dtype)
        s1, o1 = gn_fold(x, self.norm1)
        h = conv3x3_ops.conv3x3_gn_swish(x, self.conv1.weight, s1, o1,
                                         self.conv1.bias.float(), None)
        s2, o2 = gn_fold(h, self.norm2)
        res = self.nin_shortcut(x) if self.nin_shortcut is not None else x
        return conv3x3_ops.conv3x3_gn_swish(h, self.conv2.weight, s2, o2,
                                            self.conv2.bias.float(), res)

    def forward(self, x):
        if self.takes_fused(x.shape):
            return self._fused(x)
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VQAttnBlock(nn.Module):
    """Single-head softmax self-attention over all spatial positions."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = GroupNorm(num_groups32(ch), ch)
        self.q = conv(ch, ch, 1)
        self.k = conv(ch, ch, 1)
        self.v = conv(ch, ch, 1)
        self.proj_out = conv(ch, ch, 1)

    def forward(self, x):
        with span("nn.attention"):
            B, C, H, W = x.shape
            h = self.norm(x)

            def tokens(t):  # [B, C, H, W] -> [B, H*W, C], row-major over (H, W)
                return t.reshape(B, C, H * W).transpose(1, 2).float().contiguous()

            # f32 operands whatever the conv dtype, q pre-scaled by C^-1/2
            q = self.q(h)
            out = flash_attention(tokens(q * C ** -0.5), tokens(self.k(h)), tokens(self.v(h)))
            out = out.transpose(1, 2).reshape(B, C, H, W)
            return (x + self.proj_out(out)).to(q.dtype)


class Downsample(nn.Module):
    """Stride-2 3x3 conv after an asymmetric (0, 1) pad."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = conv(ch, ch, 3)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = VQResnetBlock(ch, ch)
        self.attn_1 = VQAttnBlock(ch)
        self.block_2 = VQResnetBlock(ch, ch)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class VQEncoder(nn.Module):
    """conv_in -> per-level ResnetBlocks (+attn) + Downsample -> mid ->
    GroupNorm + swish -> conv_out (z_channels, twice that with
    ``double_z``)."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (32,),
                 resolution: int = 256, z_channels: int = 4, in_channels: int = 3,
                 double_z: bool = False):
        super().__init__()
        self.conv_in = conv(in_channels, ch, 3)
        self.down = nn.ModuleList()
        curr_res, block_in = resolution, ch
        for i_level, mult in enumerate(ch_mult):
            level = _Level()
            for _ in range(num_res_blocks):
                level.block.append(VQResnetBlock(block_in, ch * mult))
                block_in = ch * mult
                if curr_res in attn_resolutions:
                    level.attn.append(VQAttnBlock(block_in))
            if i_level != len(ch_mult) - 1:
                level.downsample = Downsample(block_in)
                curr_res //= 2
            self.down.append(level)
        self.mid = _Mid(block_in)
        self.norm_out = GroupNorm(num_groups32(block_in), block_in, act="swish")
        self.conv_out = conv(block_in, 2 * z_channels if double_z else z_channels, 3)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for i, blk in enumerate(level.block):
                h = blk(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(self.norm_out(h))


class VQDecoder(nn.Module):
    """ddconfig decoder with SFT fusion taps: 'before_mid' after conv_in,
    'after_mid' after mid, 'block_1_{2^l}' after level l's blocks and before
    its upsample. The fusion blocks live outside (the reference keeps them
    in ``fusion_module``) and come in with the call."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (32,),
                 resolution: int = 256, z_channels: int = 4, out_ch: int = 3):
        super().__init__()
        num_levels = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (num_levels - 1)
        self.conv_in = conv(z_channels, block_in, 3)
        self.mid = _Mid(block_in)
        levels = [None] * num_levels
        for i_level in reversed(range(num_levels)):
            level = _Level()
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks + 1):
                level.block.append(VQResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(VQAttnBlock(block_in))
            if i_level != 0:
                level.upsample = Upsample(block_in)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(num_groups32(block_in), block_in, act="swish")
        self.conv_out = conv(block_in, out_ch, 3)

    @staticmethod
    def _fuse(key: str, h, fusion, cond_feats, w):
        if fusion is None or key not in fusion:
            return h
        if cond_feats is None or key not in cond_feats:
            raise ValueError(f"fusion key {key!r} scheduled but no cond feature given")
        return fusion[key](h, cond_feats[key], w)

    def forward(self, z, fusion: Optional[nn.ModuleDict] = None,
                cond_feats: Optional[Dict[str, torch.Tensor]] = None,
                w: float = 1.0):
        h = self.conv_in(z)
        h = self._fuse("before_mid", h, fusion, cond_feats, w)
        h = self.mid(h)
        h = self._fuse("after_mid", h, fusion, cond_feats, w)
        for i_level in reversed(range(len(self.up))):
            level = self.up[i_level]
            for i, blk in enumerate(level.block):
                h = blk(h)
                if len(level.attn):
                    h = level.attn[i](h)
            h = self._fuse(f"block_1_{2 ** i_level}", h, fusion, cond_feats, w)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h))


class VectorQuantizer(nn.Module):
    """Nearest-codeword quantizer over an [n_embed, embed_dim] codebook."""

    def __init__(self, n_embed: int = 256, embed_dim: int = 4):
        super().__init__()
        self.embedding = nn.Embedding(n_embed, embed_dim)

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B, H, W] -> latents [B, embed_dim, H, W]."""
        return self.embedding(indices.long()).permute(0, 3, 1, 2)

    def forward(self, z: torch.Tensor):
        """z [B, D, H, W] -> (z_q [B, D, H, W], indices [B, H, W] int32)."""
        idx = vq_argmin_nchw(z, self.embedding.weight)     # K1 reads z in place
        # the straight-through form z + (z_q - z) of the JAX quantizer, kept
        # for its f32 rounding
        return z + (self.lookup(idx) - z), idx


class VQModel(nn.Module):
    """VQGAN: encode returns the pre-quantization latent; the decoder is the
    base of the DC-VIC fused decoder."""

    def __init__(self, n_embed: int = 256, embed_dim: int = 4,
                 ddconfig: Optional[dict] = None):
        super().__init__()
        dd = dict(ddconfig or {})
        common = dict(ch=dd.get("ch", 128), ch_mult=tuple(dd.get("ch_mult", (1, 2, 2, 4))),
                      num_res_blocks=dd.get("num_res_blocks", 2),
                      attn_resolutions=tuple(dd.get("attn_resolutions", (32,))),
                      resolution=dd.get("resolution", 256),
                      z_channels=dd.get("z_channels", 4))
        double_z = dd.get("double_z", False)
        self.encoder = VQEncoder(in_channels=dd.get("in_channels", 3), double_z=double_z,
                                 **common)
        self.decoder = VQDecoder(out_ch=dd.get("out_ch", 3), **common)
        self.quantize = VectorQuantizer(n_embed, embed_dim)
        self.quant_conv = PointwiseLinear(common["z_channels"] * (2 if double_z else 1),
                                          embed_dim)
        self.post_quant_conv = PointwiseLinear(embed_dim, common["z_channels"])

    def encode(self, x):
        """image [-1, 1] NCHW -> pre-quant latent [B, embed_dim, H/8, W/8]."""
        return self.quant_conv(self.encoder(x))
