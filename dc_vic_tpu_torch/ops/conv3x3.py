"""3x3 stride-1 SAME convolution for the reconstruction stacks: the CUDA
kernels K5 and K6 (``csrc/conv3x3.cu`` for f32, ``csrc/conv3x3_bf16.cu``
for bf16) and their plain PyTorch versions.

Port of ``dc_vic_tpu/ops/conv3x3.py`` in the port's layouts (NCHW maps, OIHW
weights).
``conv3x3_same`` (K5) is the conv alone, without bias; ``conv3x3_gn_swish``
(K6) is ``conv3x3(swish(x * scale[b] + bias[b])) + cbias (+ res)`` with the
zero padding applied after the affine and swish. Dispatch is by device: a CPU
tensor takes the ``*_plain`` version; a CUDA tensor launches the kernel or
raises. ``use_kernel`` is the shape rule by which the modules choose these
kernels over their ordinary PyTorch code. Both go through a
``torch.autograd.Function`` (on the CPU too) whose backward is PyTorch, as the
JAX package's custom VJPs take XLA's: K5 the conv's input and weight
gradients, K6 those of its plain composite, with the affine and swish
recomputed from the saved input (the activations are not kept).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import native
from .layout import row_major as _row_major
from .layout import widen

# Kernel launches since the last reset (counted where each kernel launches),
# and backward passes of the Functions on CUDA tensors (PyTorch, no kernel).
launches = {"conv3x3_same": 0, "conv3x3_gn_swish": 0}
backwards = {"conv3x3_same": 0, "conv3x3_gn_swish": 0}

# what the kernels' tiles need, by dtype: input channels staged 8 (f32,
# csrc/conv3x3.cu: one TF32 k8 step per tap) or 16 (bf16, csrc/conv3x3_bf16.cu:
# one k16 step) at a time, output channels in multiples of 64
_C_STEP = {torch.float32: 8, torch.bfloat16: 16}
_F32 = 0   # the dtype code of csrc/conv3x3.cu's entry points for f32
_COUT_STEP = 64
# the bf16 kernels' output-channel tile (a wgmma's N): the repacked weights
# are padded with zeros to a multiple of it
_BF16_COUT_TILE = 128


def use_kernel(B: int, C: int, Cout: int, H: int, W: int) -> bool:
    """The JAX package's rule for its 3x3 conv kernels (the same for the
    plain and the fused one), without its backend test: channel counts that
    are multiples of 128, even H and W, a plane of at least 12288 positions
    and at least 16384 positions in the batch."""
    return (C % 128 == 0 and Cout % 128 == 0 and H % 2 == 0 and W % 2 == 0
            and H * W >= 12288 and B * H * W >= 16384)


def _check(x: torch.Tensor, w: torch.Tensor, what: str) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"{what}: expected x [B, C, H, W] and w [Cout, C, 3, 3], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _C_STEP or w.dtype != x.dtype:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 x and w of one "
                        f"type, got {x.dtype} and {w.dtype}")
    c_step = _C_STEP[x.dtype]
    if x.shape[1] % c_step or w.shape[0] % _COUT_STEP:
        raise ValueError(f"{what} kernel needs C % {c_step} == 0 and Cout % {_COUT_STEP} "
                         f"== 0 in {x.dtype}, got C={x.shape[1]}, Cout={w.shape[0]}")
    if x.numel() == 0 or x.shape[0] > 65535:
        raise ValueError(f"{what}: unsupported input shape {tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError(f"{what}: x and w must be on the same device")


def _padded_cout(Cout: int) -> int:
    return -(-Cout // _BF16_COUT_TILE) * _BF16_COUT_TILE


def _weight_scratch(C: int, Cout: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """Where the kernels' first pass writes the weights as the operands the
    tensor cores read from shared memory. f32: each value split in a TF32 hi
    and lo part, twice the weights' size in f32. bf16: the values as they
    are, Cout padded to the output-channel tile (``repack_weights_bf16_plain``
    is the layout)."""
    if dtype == torch.bfloat16:
        return torch.empty(C * 9 * _padded_cout(Cout), dtype=dtype, device=device)
    return torch.empty(2 * C * 9 * Cout, dtype=torch.float32, device=device)


def repack_weights_bf16_plain(w: torch.Tensor) -> torch.Tensor:
    """w [Cout, C, 3, 3] as the bf16 kernels' B operands: [C / 16, 9,
    Coutp / 8, 2, 8, 8] where element (c16, tap, n8, half, r, k) is
    w[n8 * 8 + r, c16 * 16 + half * 8 + k, tap // 3, tap % 3] and zero for an
    output channel at or beyond Cout (Coutp: Cout rounded up to 128). For one
    step of 16 input channels and one tap, the [Coutp x 16] operand is made
    of K-major core matrices of 8 output x 8 input channels (128 bytes):
    128 bytes apart along K (``half``), 256 along N (``n8``)."""
    Cout, C = w.shape[:2]
    wp = torch.zeros((_padded_cout(Cout), C, 3, 3), dtype=torch.bfloat16, device=w.device)
    wp[:Cout] = w
    t = wp.reshape(-1, 8, C // 16, 2, 8, 9)            # [n8, r, c16, half, k, tap]
    return t.permute(2, 5, 0, 3, 1, 4).contiguous()    # [c16, tap, n8, half, r, k]


def repack_weights_bf16(w: torch.Tensor) -> torch.Tensor:
    """The bf16 kernels' weight repack alone: on a CUDA tensor the kernel
    that K5 and K6 launch first (so that its bits can be held against
    ``repack_weights_bf16_plain``), on a CPU tensor the plain version."""
    if w.dtype != torch.bfloat16 or w.dim() != 4 or tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"repack_weights_bf16: expected bf16 w [Cout, C, 3, 3], got "
                         f"{w.dtype} {tuple(w.shape)}")
    Cout, C = w.shape[:2]
    if C % _C_STEP[torch.bfloat16] or Cout % _COUT_STEP:
        raise ValueError(f"repack_weights_bf16 needs C % 16 == 0 and Cout % 64 == 0, got "
                         f"C={C}, Cout={Cout}")
    if w.device.type == "cpu":
        return repack_weights_bf16_plain(w)
    w = _row_major(w)
    out = _weight_scratch(C, Cout, w.dtype, w.device)
    lib = native.kernels()
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcvic_repack_weights_bf16(w.data_ptr(), out.data_ptr(), C, Cout, stream)
    native.check(err, "repack_weights_bf16")
    return out.view(C // 16, 9, -1, 2, 8, 8)


# ------------------------------------------------------------------- K5

def conv3x3_same_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 conv with zero padding 1 and no bias, in x's type."""
    return F.conv2d(x, w, padding=1)


def _conv3x3_same_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, w, "conv3x3_same")
    B, C, H, W = x.shape
    Cout = w.shape[0]
    x, w = _row_major(x), _row_major(w)
    out = torch.empty(B, Cout, H, W, dtype=x.dtype, device=x.device)
    repacked = _weight_scratch(C, Cout, x.dtype, x.device)
    lib = native.kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.bfloat16:
            err = lib.dcvic_conv3x3_same_bf16(x.data_ptr(), w.data_ptr(), repacked.data_ptr(),
                                              out.data_ptr(), B, C, Cout, H, W, stream)
        else:
            err = lib.dcvic_conv3x3_same(x.data_ptr(), w.data_ptr(), repacked.data_ptr(),
                                         out.data_ptr(), B, C, Cout, H, W, _F32, stream)
    native.check(err, "conv3x3_same")
    launches["conv3x3_same"] += 1
    return out


class _Conv3x3Same(torch.autograd.Function):
    """K5 forward (the plain version on the CPU); backward: the conv's
    input and weight gradients."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return conv3x3_same_plain(x, w)
        return _conv3x3_same_cuda(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if x.device.type == "cuda":
            backwards["conv3x3_same"] += 1
        g = g.to(x.dtype)
        need_x, need_w = ctx.needs_input_grad
        dx = torch.nn.grad.conv2d_input(x.shape, w, g, padding=1) if need_x else None
        dw = torch.nn.grad.conv2d_weight(x, w.shape, g, padding=1) if need_w else None
        return dx, dw


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv of x [B, C, H, W] against w [Cout, C, 3, 3]
    with f32 accumulation and no bias; returns [B, Cout, H, W] in x's type."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_same: unsupported device {x.device}")
    return _Conv3x3Same.apply(x, w)


# ------------------------------------------------------------------- K6

def _swish_affine(x, scale, bias):
    """The K6 prologue as its plain version computes it, cast to x's type."""
    h = widen(x) * widen(scale)[:, :, None, None] + widen(bias)[:, :, None, None]
    return (h * torch.sigmoid(h)).to(x.dtype)


def conv3x3_gn_swish_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, cbias: torch.Tensor,
                           res: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused composite step by step: affine and swish in f32, cast to
    x's type, conv with zero padding, then the conv bias and the residual in
    f32, and one cast to x's type at the end. The conv of the cast
    activations and the weights runs in f32 (products of bf16 values are
    exact there), so a bf16 result is rounded once, as the kernels and the
    JAX package's kernel round it."""
    h = _swish_affine(x, scale, bias)
    y = F.conv2d(widen(h), widen(w), padding=1) + widen(cbias)[None, :, None, None]
    if res is not None:
        y = y + widen(res)
    return y.to(x.dtype)


def _conv3x3_gn_swish_cuda(x, w, scale, bias, cbias, res):
    _check(x, w, "conv3x3_gn_swish")
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
    repacked = _weight_scratch(C, Cout, x.dtype, x.device)
    lib = native.kernels()
    operands = (x.data_ptr(), w.data_ptr(), repacked.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), cbias.data_ptr(), None if res is None else res.data_ptr(),
                out.data_ptr(), B, C, Cout, H, W)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if x.dtype == torch.bfloat16:
            err = lib.dcvic_conv3x3_gn_swish_bf16(*operands, stream)
        else:
            err = lib.dcvic_conv3x3_gn_swish(*operands, _F32, stream)
    native.check(err, "conv3x3_gn_swish")
    launches["conv3x3_gn_swish"] += 1
    return out


class _Conv3x3GnSwish(torch.autograd.Function):
    """K6 forward (the plain version on the CPU). Saves x, w, scale and
    bias; the backward recomputes the prologue and takes the gradient of
    ``conv3x3_gn_swish_plain``: the conv's input and weight gradients of
    the f32 sum, the prologue by autograd, cbias and res directly."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, cbias, res):
        ctx.save_for_backward(x, w, scale, bias)
        ctx.res_dtype = None if res is None else res.dtype
        ctx.cbias_dtype = cbias.dtype
        if x.device.type == "cpu":
            return conv3x3_gn_swish_plain(x, w, scale, bias, cbias, res)
        return _conv3x3_gn_swish_cuda(x, w, scale, bias, cbias, res)

    @staticmethod
    def backward(ctx, g):
        x, w, scale, bias = ctx.saved_tensors
        if x.device.type == "cuda":
            backwards["conv3x3_gn_swish"] += 1
        need_x, need_w, need_s, need_b, need_cb, need_res = ctx.needs_input_grad
        gf = widen(g)
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((x, scale, bias), (need_x, need_s, need_b))]
        with torch.enable_grad():
            h = _swish_affine(*inputs)
        dw = None
        if need_w:
            dw = torch.nn.grad.conv2d_weight(widen(h.detach()), w.shape, gf, padding=1).to(w.dtype)
        grads = [None, None, None]
        if need_x or need_s or need_b:
            dh = torch.nn.grad.conv2d_input(h.shape, widen(w), gf, padding=1)
            want = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(h, want, dh.to(h.dtype)))
            grads = [next(got) if t.requires_grad else None for t in inputs]
        dcb = gf.sum(dim=(0, 2, 3)).to(ctx.cbias_dtype) if need_cb else None
        dres = g.to(ctx.res_dtype) if need_res else None
        return grads[0], dw, grads[1], grads[2], dcb, dres


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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_gn_swish: unsupported device {x.device}")
    return _Conv3x3GnSwish.apply(x, w, scale, bias, cbias, res)
