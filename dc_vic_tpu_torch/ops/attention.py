"""Single-head attention: the CUDA kernel K2 (``csrc/flash_attn_f32.cu``)
and its plain PyTorch version.

Port of ``dc_vic_tpu/ops/attention.py`` (forward only: the codec path runs
under ``torch.no_grad``). Dispatch is by device: a CPU tensor takes
``attention_plain``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import native

# Kernel launches since the last reset (counted where the kernel launches).
launches = 0


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v over [B, N, C] in f32 (q pre-scaled)."""
    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    return torch.bmm(torch.softmax(s, dim=-1), v.float())


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    global launches
    if not (q.dtype == k.dtype == v.dtype == torch.float32):
        raise TypeError("flash_attention kernel takes float32 operands")
    if q.dim() != 3 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"expected equal [B, N, C] shapes, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, N, C = q.shape
    if C % 4 != 0 or C > 512:
        raise ValueError(f"flash_attention kernel needs C % 4 == 0 and C <= 512, got C={C}")
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v for [B, N, C] operands with q pre-scaled by C^-1/2."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if q.device.type == "cuda":
        return _flash_attention_cuda(q, k, v)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
