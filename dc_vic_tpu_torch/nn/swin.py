"""Swin transformer blocks (RSTB) of the VQ estimator (port of
dc_vic_tpu/nn/swin.py).

Plain tensor code, as the JAX package leaves it to XLA. Blocks take and
return NCHW maps and work on NHWC tokens inside. LayerNorm uses flax's
epsilon (1e-6) and the MLP flax's tanh-approximated GELU.

Under a bf16 compute dtype (dense weights rounded to bf16 at build) the
tokens are bf16, and as in the JAX package the attention scores accumulate
in f32, take the f32 position bias and mask, go through the softmax in f32
and are cast back to the tokens' dtype before they meet v; LayerNorm keeps
f32 parameters, normalises in f32 and returns the tokens' dtype.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from .layers import conv


def _relative_position_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] index into the (2ws-1)^2 relative position bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def _shift_attn_mask(H: int, W: int, ws: int, shift: int, device=None) -> torch.Tensor:
    """Additive attention mask [num_windows, ws*ws, ws*ws] for shifted windows,
    built on ``device`` from index arithmetic: no host data to upload, so a
    decode chain that meets a new image size does not wait for a copy."""
    def region(n):  # the three bands of the shifted grid: [0, n-ws), [n-ws, n-shift), rest
        i = torch.arange(n, device=device)
        return (i >= n - ws).to(torch.int32) + (i >= n - shift).to(torch.int32)
    img = region(H)[:, None] * 3 + region(W)[None, :]
    win = img.reshape(H // ws, ws, W // ws, ws).transpose(1, 2).reshape(-1, ws * ws)
    mask = win[:, None, :] - win[:, :, None]
    return torch.where(mask != 0, -100.0, 0.0).to(torch.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window_size).reshape(-1)),
            persistent=False)

    def forward(self, xw, mask=None):
        # xw: [B*nW, N, C] tokens of each window
        with span("nn.attention"):
            Bn, N, C = xw.shape
            h = self.num_heads
            hd = C // h
            qkv = self.qkv(xw).reshape(Bn, N, 3, h, hd).permute(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]                    # [Bn, h, N, hd]
            # f32 scores: products of the tokens' values, summed in f32
            attn = (q * hd ** -0.5).float() @ k.float().transpose(-2, -1)
            bias = self.relative_position_bias_table[self.relative_position_index]
            attn = attn + bias.reshape(N, N, h).permute(2, 0, 1)[None]
            if mask is not None:
                nW = mask.shape[0]
                attn = attn.reshape(Bn // nW, nW, h, N, N) + mask[None, :, None]
                attn = attn.reshape(Bn, h, N, N)
            out = torch.softmax(attn, dim=-1).to(xw.dtype) @ v
            return self.proj(out.transpose(1, 2).reshape(Bn, N, C))


class LayerNorm(nn.LayerNorm):
    """LayerNorm in f32 whatever the tokens' dtype, cast back on return."""

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def _mask(self, H: int, W: int, shift: int, device) -> torch.Tensor:
        key = (H, W, shift, str(device))
        if key not in self._masks:
            self._masks[key] = _shift_attn_mask(H, W, self.window_size, shift, device)
        return self._masks[key]

    def forward(self, x):
        # x: [B, H, W, C] tokens, H and W multiples of the window
        B, H, W, C = x.shape
        ws = self.window_size
        shift = self.shift_size if min(H, W) > ws else 0

        y = self.norm1(x)
        if shift > 0:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
        yw = y.reshape(B, H // ws, ws, W // ws, ws, C)
        yw = yw.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)
        mask = self._mask(H, W, shift, x.device) if shift > 0 else None
        yw = self.attn(yw, mask)
        y = yw.reshape(B, H // ws, W // ws, ws, ws, C)
        y = y.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)
        if shift > 0:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class _ResidualGroup(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """Residual Swin Transformer Block: depth Swin blocks (alternating
    shift), then a 3x3 conv, inside a residual connection. NCHW in and out."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.residual_group = _ResidualGroup(
            SwinBlock(dim, num_heads, window_size,
                      shift_size=0 if i % 2 == 0 else window_size // 2,
                      mlp_ratio=mlp_ratio)
            for i in range(depth))
        self.conv = conv(dim, dim, 3)

    def forward(self, x):
        y = x.permute(0, 2, 3, 1)
        for blk in self.residual_group.blocks:
            y = blk(y)
        return x + self.conv(y.permute(0, 3, 1, 2).contiguous())
