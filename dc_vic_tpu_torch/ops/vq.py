"""Nearest-codeword search: the CUDA kernel K1 (``csrc/vq_argmin.cu``) and
its plain PyTorch version.

Port of ``dc_vic_tpu/ops/vq.py``. Dispatch is by device: a CPU tensor takes
``vq_argmin_plain``; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import native

# Kernel launches since the last reset (counted where the kernel launches).
launches = 0

_MAX_SMEM = 227 * 1024


def vq_argmin_plain(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_n(||e_n||^2 - 2 z.e_n) per row; the first minimum wins ties
    (torch.argmin's rule). Returns [M] int32."""
    z = z_flat.float()
    cb = codebook.float()
    dist = (cb * cb).sum(-1)[None] - 2.0 * (z @ cb.t())
    return torch.argmin(dist, dim=-1).to(torch.int32)


def _vq_argmin_cuda(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    global launches
    if z_flat.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError("vq_argmin kernel takes float32 operands")
    if z_flat.dim() != 2 or codebook.dim() != 2 or z_flat.shape[1] != codebook.shape[1]:
        raise ValueError(f"bad shapes {tuple(z_flat.shape)} / {tuple(codebook.shape)}")
    M, D = z_flat.shape
    N = codebook.shape[0]
    if D != 4:
        raise ValueError(f"vq_argmin kernel supports embed_dim 4, got {D}")
    if N * 20 > _MAX_SMEM:
        raise ValueError(f"codebook of {N} entries exceeds shared memory")
    if codebook.device != z_flat.device:
        raise ValueError("z and codebook must be on the same device")
    z = z_flat.contiguous()
    cb = codebook.contiguous()
    if z.data_ptr() % 16 or cb.data_ptr() % 16:
        raise ValueError("vq_argmin kernel needs 16-byte aligned operands")
    out = torch.empty(M, dtype=torch.int32, device=z.device)
    if M == 0:
        return out
    lib = native.kernels()
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcvic_vq_argmin(z.data_ptr(), cb.data_ptr(), out.data_ptr(),
                                  M, N, D, stream)
    native.check(err, "vq_argmin")
    launches += 1
    return out


def vq_argmin(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codebook index for each row of z_flat [M, D] against
    codebook [N, D]; returns [M] int32."""
    if z_flat.device.type == "cpu":
        return vq_argmin_plain(z_flat, codebook)
    if z_flat.device.type == "cuda":
        return _vq_argmin_cuda(z_flat, codebook)
    raise ValueError(f"vq_argmin: unsupported device {z_flat.device}")
