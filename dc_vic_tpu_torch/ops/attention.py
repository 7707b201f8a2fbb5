"""Single-head attention: the CUDA kernel K2 (``csrc/flash_attn_f32.cu``)
and its plain PyTorch version.

Port of ``dc_vic_tpu/ops/attention.py``. The kernel takes its products on the tensor cores
as an error-compensated 3xTF32 split (``csrc/tf32x3.cuh``, ``ops/tf32.py``),
so its results stay f32-class. Dispatch is by device and shape: a CPU tensor
takes ``attention_plain``; a CUDA tensor launches the kernel where
``use_kernel`` allows it and takes ``attention_plain`` on the card otherwise,
as the JAX package takes XLA outside its kernel's rule. The kernel's output
carries a gradient: ``_FlashAttention`` is a ``torch.autograd.Function``
whose backward recomputes the probabilities in PyTorch, as the JAX package's
custom VJP recomputes them in XLA (``attention_backward``). On the CPU the
same Function runs the plain forward.
"""
from __future__ import annotations

import torch

from . import native
from .layout import widen

# Kernel launches since the last reset (counted where the kernel launches),
# and backward passes of the Function on a CUDA tensor (PyTorch, no kernel).
launches = 0
backwards = 0

_WIDTHS = (128, 256, 384, 512)


def use_kernel(shape, dtype) -> bool:
    """The kernel's own limits: float32 [B, N, C] operands with C one of
    128, 256, 384, 512 (whole 128-channel chunks); any N."""
    return dtype == torch.float32 and len(shape) == 3 and shape[-1] in _WIDTHS


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v over [B, N, C] in f32 (q pre-scaled)."""
    s = torch.bmm(widen(q), widen(k).transpose(1, 2))
    return torch.bmm(torch.softmax(s, dim=-1), widen(v))


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    global launches
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError("flash_attention kernel takes float32 operands")
    if q.dim() != 3 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"expected equal [B, N, C] shapes, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, N, C = q.shape
    if C not in _WIDTHS:
        raise ValueError(f"flash_attention kernel needs C in (128, 256, 384, 512), got C={C}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on the same device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs 16-byte aligned operands")
    out = torch.empty_like(q)
    if B == 0 or N == 0:
        return out
    lib = native.kernels()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcvic_flash_attn_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                       out.data_ptr(), B, N, C, stream)
    native.check(err, "flash_attention")
    launches += 1
    return out


def attention_backward(q, k, v, g):
    """(dq, dk, dv) of softmax(q k^T) v for the output gradient g, the
    probabilities recomputed in f32 (the JAX package's ``_bwd``)."""
    p = torch.softmax(torch.bmm(widen(q), widen(k).transpose(1, 2)), dim=-1)
    gf = widen(g)
    dv = torch.bmm(p.transpose(1, 2), gf)
    dp = torch.bmm(gf, widen(v).transpose(1, 2))
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.bmm(ds, widen(k))
    dk = torch.bmm(ds.transpose(1, 2), widen(q))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """K2 forward (the plain version on the CPU), ``attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return attention_plain(q, k, v)
        return _flash_attention_cuda(q, k, v)

    @staticmethod
    def backward(ctx, g):
        global backwards
        q, k, v = ctx.saved_tensors
        if q.device.type == "cuda":
            backwards += 1
        return attention_backward(q, k, v, g)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v for [B, N, C] operands with q pre-scaled by C^-1/2.
    On a CUDA tensor the kernel runs where ``use_kernel`` allows it; other
    shapes and dtypes take the plain version on the card (differentiated by
    autograd). Kernel and CPU calls go through ``_FlashAttention``."""
    if q.device.type == "cpu":
        return _FlashAttention.apply(q, k, v)
    if q.device.type == "cuda":
        if use_kernel(q.shape, q.dtype):
            return _FlashAttention.apply(q, k, v)
        return attention_plain(q, k, v)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
