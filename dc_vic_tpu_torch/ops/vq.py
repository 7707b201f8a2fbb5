"""Nearest-codeword search: the CUDA kernel K1 (``csrc/vq_argmin.cu``) and
its plain PyTorch version.

Port of ``dc_vic_tpu/ops/vq.py``. Two entries run the one kernel:
``vq_argmin`` on flat rows [M, D], the JAX package's signature, and
``vq_argmin_nchw`` on the quantizer's NCHW latent [B, D, H, W], which the
kernel reads where it lies, through strides, with no permuted copy.
Dispatch is by device and shape: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel where ``use_kernel`` allows it and takes the
plain version on the card otherwise, as the JAX package takes XLA outside
its kernel's rule.
"""
from __future__ import annotations

import functools

import torch

from . import native

# Kernel launches since the last reset (counted where the kernel launches).
launches = 0

_MAX_SMEM = 227 * 1024
_CODEWORD_SMEM = 20     # bytes of shared memory per codeword: 4 components and |e|^2
# the kernel's partition (csrc/vq_argmin.cu): LANES lanes scan a row's
# codebook, THREADS threads a block
LANES = 4
THREADS = 128


def use_kernel(D: int, N: int, dtype) -> bool:
    """The kernel's own limits: float32 rows of D = 4 components against a
    codebook of N entries that fits shared memory."""
    return dtype == torch.float32 and D == 4 and N * _CODEWORD_SMEM <= _MAX_SMEM


def rows_per_thread(M: int, sms: int) -> int:
    """R, the rows each thread of the kernel holds: 4 or 2 where that still
    gives every one of ``sms`` SMs two blocks, else 1."""
    for R in (4, 2):
        if -(-M // (THREADS // LANES * R)) >= 2 * sms:
            return R
    return 1


def vq_argmin_plain(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_n(||e_n||^2 - 2 z.e_n) per row; the first minimum wins ties
    (torch.argmin's rule). Returns [M] int32."""
    z = z_flat.float()
    cb = codebook.float()
    dist = (cb * cb).sum(-1)[None] - 2.0 * (z @ cb.t())
    return torch.argmin(dist, dim=-1).to(torch.int32)


def vq_argmin_nchw_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """``vq_argmin_plain`` of the latent's positions as rows: [B, H, W]."""
    B, D, H, W = z.shape
    return vq_argmin_plain(z.permute(0, 2, 3, 1).reshape(-1, D), codebook).reshape(B, H, W)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flat_layout(z_flat: torch.Tensor):
    """(z, B, HW, (sb, sd, shw)) of flat rows [M, 4] for the kernel: one
    image of M positions, component d of row m at element d sd + m shw."""
    if z_flat.dim() != 2 or z_flat.shape[1] != 4:
        raise ValueError(f"vq_argmin kernel takes rows of 4, got {tuple(z_flat.shape)}")
    return z_flat, 1, z_flat.shape[0], (0, z_flat.stride(1), z_flat.stride(0))


def nchw_layout(z: torch.Tensor):
    """(z, B, HW, (sb, sd, shw)) of a latent [B, 4, H, W] for the kernel:
    component d of position hw of image b at element b sb + d sd + hw shw,
    read in place wherever H and W merge into one stride (a copy otherwise)."""
    if z.dim() != 4 or z.shape[1] != 4:
        raise ValueError(f"vq_argmin kernel takes [B, 4, H, W], got {tuple(z.shape)}")
    B, _, H, W = z.shape
    if H > 1 and z.stride(2) != W * z.stride(3):
        z = z.contiguous()
    return z, B, H * W, (z.stride(0), z.stride(1), z.stride(3))


def _launch(z: torch.Tensor, B: int, HW: int, strides,
            codebook: torch.Tensor) -> torch.Tensor:
    """The kernel on the B * HW rows of a layout (``flat_layout``,
    ``nchw_layout``); [B * HW] int32."""
    global launches
    if z.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError("vq_argmin kernel takes float32 operands")
    if codebook.dim() != 2 or codebook.shape[1] != 4:
        raise ValueError(f"vq_argmin kernel supports embed_dim 4, got {tuple(codebook.shape)}")
    if codebook.device != z.device:
        raise ValueError("z and codebook must be on the same device")
    N = codebook.shape[0]
    if N * _CODEWORD_SMEM > _MAX_SMEM:
        raise ValueError(f"codebook of {N} entries exceeds shared memory")
    M = B * HW
    out = torch.empty(M, dtype=torch.int32, device=z.device)
    if M == 0:
        return out
    cb = codebook.contiguous()
    lib = native.kernels()
    index = z.device.index
    with torch.cuda.device(index):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcvic_vq_argmin(z.data_ptr(), cb.data_ptr(), out.data_ptr(), M, N, HW,
                                  *strides, rows_per_thread(M, _sm_count(index)), stream)
    native.check(err, "vq_argmin")
    launches += 1
    return out


def _vq_argmin_cuda(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    return _launch(*flat_layout(z_flat), codebook)


def _vq_argmin_nchw_cuda(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    B, _, H, W = z.shape
    return _launch(*nchw_layout(z), codebook).reshape(B, H, W)


def _dispatch(kernel, plain, z: torch.Tensor, D: int, codebook: torch.Tensor):
    if z.device.type == "cpu":
        return plain(z, codebook)
    if z.device.type == "cuda":
        if use_kernel(D, codebook.shape[0], z.dtype):
            return kernel(z, codebook)
        return plain(z, codebook)
    raise ValueError(f"vq_argmin: unsupported device {z.device}")


def vq_argmin(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codebook index for each row of z_flat [M, D] against
    codebook [N, D]; returns [M] int32. On a CUDA tensor the kernel runs
    where ``use_kernel`` allows it; other shapes take the plain version on
    the card."""
    return _dispatch(_vq_argmin_cuda, vq_argmin_plain, z_flat, z_flat.shape[-1], codebook)


def vq_argmin_nchw(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest codebook index for each position of the latent z [B, D, H, W];
    returns [B, H, W] int32, equal to ``vq_argmin`` of the positions as rows.
    The kernel reads z in place."""
    return _dispatch(_vq_argmin_nchw_cuda, vq_argmin_nchw_plain, z, z.shape[1], codebook)
