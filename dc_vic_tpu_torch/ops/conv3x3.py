"""3x3 stride-1 SAME convolution for the reconstruction stacks: the CUDA
kernels K5 and K6 (``csrc/conv3x3.cu``) and their plain PyTorch versions.

Port of ``dc_vic_tpu/ops/conv3x3.py`` in the port's layouts (NCHW maps, OIHW
weights; forward only: the codec path runs under ``torch.no_grad``).
``conv3x3_same`` (K5) is the conv alone, without bias; ``conv3x3_gn_swish``
(K6) is ``conv3x3(swish(x * scale[b] + bias[b])) + cbias (+ res)`` with the
zero padding applied after the affine and swish. Dispatch is by device: a CPU
tensor takes the ``*_plain`` version; a CUDA tensor launches the kernel or
raises. ``use_kernel`` is the shape rule by which the modules choose these
kernels over their ordinary PyTorch code.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import native
from .layout import row_major as _row_major

# Kernel launches since the last reset (counted where each kernel launches).
launches = {"conv3x3_same": 0, "conv3x3_gn_swish": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# what the kernels' tiles need: input channels staged 8 at a time (one
# tensor-core k8 step per tap), output channels in tiles of 64 (a wgmma's N)
_C_STEP, _COUT_STEP = 8, 64


def use_kernel(B: int, C: int, Cout: int, H: int, W: int) -> bool:
    """The JAX package's rule for its 3x3 conv kernels (the same for the
    plain and the fused one), without its backend test: channel counts that
    are multiples of 128, even H and W, a plane of at least 12288 positions
    and at least 16384 positions in the batch."""
    return (C % 128 == 0 and Cout % 128 == 0 and H % 2 == 0 and W % 2 == 0
            and H * W >= 12288 and B * H * W >= 16384)


def _check(x: torch.Tensor, w: torch.Tensor, what: str) -> int:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"{what}: expected x [B, C, H, W] and w [Cout, C, 3, 3], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 x and w of one "
                        f"type, got {x.dtype} and {w.dtype}")
    if x.shape[1] % _C_STEP or w.shape[0] % _COUT_STEP:
        raise ValueError(f"{what} kernel needs C % {_C_STEP} == 0 and Cout % "
                         f"{_COUT_STEP} == 0, got C={x.shape[1]}, Cout={w.shape[0]}")
    if x.numel() == 0 or x.shape[0] > 65535:
        raise ValueError(f"{what}: unsupported input shape {tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError(f"{what}: x and w must be on the same device")
    return _DTYPES[x.dtype]


def _weight_scratch(C: int, Cout: int, device: torch.device) -> torch.Tensor:
    """Where the kernels' first pass writes the weights as the operands the
    tensor cores read from shared memory, each value split in a TF32 hi and
    lo part: twice the weights' size in f32."""
    return torch.empty(2 * C * 9 * Cout, dtype=torch.float32, device=device)


# ------------------------------------------------------------------- K5

def conv3x3_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 conv with zero padding 1 and no bias, in x's type."""
    return F.conv2d(x, w, padding=1)


def _conv3x3_same_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    dtype = _check(x, w, "conv3x3_same")
    B, C, H, W = x.shape
    Cout = w.shape[0]
    x, w = _row_major(x), _row_major(w)
    out = torch.empty(B, Cout, H, W, dtype=x.dtype, device=x.device)
    repacked = _weight_scratch(C, Cout, x.device)
    lib = native.kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcvic_conv3x3_same(x.data_ptr(), w.data_ptr(), repacked.data_ptr(),
                                     out.data_ptr(), B, C, Cout, H, W, dtype, stream)
    native.check(err, "conv3x3_same")
    launches["conv3x3_same"] += 1
    return out


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv of x [B, C, H, W] against w [Cout, C, 3, 3]
    with f32 accumulation and no bias; returns [B, Cout, H, W] in x's type."""
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, w)
    if x.device.type == "cuda":
        return _conv3x3_same_cuda(x, w)
    raise ValueError(f"conv3x3_same: unsupported device {x.device}")


# ------------------------------------------------------------------- K6

def conv3x3_gn_swish_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, cbias: torch.Tensor,
                           res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused composite step by step: affine and swish in f32, cast to
    x's type, conv with zero padding, then the conv bias and the residual in
    f32."""
    h = x.float() * scale.float()[:, :, None, None] + bias.float()[:, :, None, None]
    h = (h * torch.sigmoid(h)).to(x.dtype)
    y = F.conv2d(h, w, padding=1).float() + cbias.float()[None, :, None, None]
    if res is not None:
        y = y + res.float()
    return y.to(x.dtype)


def _conv3x3_gn_swish_cuda(x, w, scale, bias, cbias, res):
    dtype = _check(x, w, "conv3x3_gn_swish")
    B, C, H, W = x.shape
    Cout = w.shape[0]
    small = (scale, bias, cbias)
    if any(t.dtype != torch.float32 for t in small):
        raise TypeError("conv3x3_gn_swish kernel takes float32 scale, bias and cbias")
    if res is not None and res.dtype != x.dtype:
        raise TypeError(f"conv3x3_gn_swish: res is {res.dtype}, x is {x.dtype}")
    if any(t.device != x.device for t in small + (() if res is None else (res,))):
        raise ValueError("conv3x3_gn_swish: all operands must be on one device")
    x, w = _row_major(x), _row_major(w)
    scale, bias, cbias = (_row_major(t) for t in small)
    res = None if res is None else _row_major(res)
    out = torch.empty(B, Cout, H, W, dtype=x.dtype, device=x.device)
    repacked = _weight_scratch(C, Cout, x.device)
    lib = native.kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcvic_conv3x3_gn_swish(
            x.data_ptr(), w.data_ptr(), repacked.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), cbias.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(),
            B, C, Cout, H, W, dtype, stream)
    native.check(err, "conv3x3_gn_swish")
    launches["conv3x3_gn_swish"] += 1
    return out


def conv3x3_gn_swish(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, cbias: torch.Tensor,
                     res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv3x3_same(swish(x * scale[b] + bias[b]), w) + cbias (+ res).
    x [B, C, H, W]; w [Cout, C, 3, 3]; scale, bias [B, C] f32 (GroupNorm
    statistics and gamma, beta folded per image); cbias [Cout] f32; res
    [B, Cout, H, W] or None. Returns x's type."""
    B, C = x.shape[:2]
    Cout = w.shape[0]
    if (tuple(scale.shape) != (B, C) or tuple(bias.shape) != (B, C)
            or tuple(cbias.shape) != (Cout,)):
        raise ValueError(f"conv3x3_gn_swish: scale {tuple(scale.shape)}, bias "
                         f"{tuple(bias.shape)}, cbias {tuple(cbias.shape)} for x "
                         f"{tuple(x.shape)} and w {tuple(w.shape)}")
    if res is not None and tuple(res.shape) != (B, Cout) + tuple(x.shape[2:]):
        raise ValueError(f"conv3x3_gn_swish: res {tuple(res.shape)} for output "
                         f"{(B, Cout) + tuple(x.shape[2:])}")
    if x.device.type == "cpu":
        return conv3x3_gn_swish_plain(x, w, scale, bias, cbias, res)
    if x.device.type == "cuda":
        return _conv3x3_gn_swish_cuda(x, w, scale, bias, cbias, res)
    raise ValueError(f"conv3x3_gn_swish: unsupported device {x.device}")
