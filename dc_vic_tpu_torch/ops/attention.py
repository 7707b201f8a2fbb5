"""Single-head attention: the CUDA kernel K2 (``csrc/flash_attn_f32.cu``)
and its plain PyTorch version.

Port of ``dc_vic_tpu/ops/attention.py``. The kernel takes its products on the
tensor cores as an error-compensated 3xTF32 split (``csrc/tf32x3.cuh``,
``ops/tf32.py``), so its results stay f32-class: warpgroup products
(``wgmma``) whose B operands are K and V, split once per block into hi and
lo planes in shared memory. ``stage_q_plain`` and ``stage_kv_plain`` build
the shared-memory images the kernel writes (Q in the order of its A
fragments; K and the transposed V in the core-matrix layout, V's keys in the
order of P's fragments), so that the CPU tests can read the products'
operands back out of them. Dispatch is by device and shape: a CPU tensor
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
from .tf32 import split_tf32

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


# The kernel's tiling (csrc/flash_attn_f32.cu): a block owns QUERY_ROWS rows
# and two warpgroups of 128 threads, warpgroup wg the channels and output
# columns [wg C/2, (wg + 1) C/2); a key tile is KEY_TILE keys, staged as K
# chunks of K_CHUNK channels and V chunks of V_KEYS keys x V_CHUNK columns.
QUERY_ROWS, KEY_TILE, K_CHUNK, V_CHUNK, V_KEYS = 64, 32, 32, 64, 16


def stage_q_plain(q: torch.Tensor, row0: int) -> torch.Tensor:
    """The Q image of the block that owns rows [row0, row0 + QUERY_ROWS) of
    one image's q [N, C], as the kernel writes it: float4 slot e = (warp w,
    k8 step j, lane) holds q[r][8j + t], q[r + 8][8j + t], q[r][8j + t + 4],
    q[r + 8][8j + t + 4] with r = row0 + 16w + lane // 4 and t = lane % 4;
    rows past N read as zeros. Flat float32, raw (not split)."""
    N, C = q.shape
    e = torch.arange(QUERY_ROWS * C // 4)
    ln, j, wq = e % 32, (e // 32) % (C // 8), (e // 32) // (C // 8)
    r = (row0 + 16 * wq + ln // 4).view(-1, 1) + torch.tensor([0, 8, 0, 8])
    col = (8 * j + ln % 4).view(-1, 1) + torch.tensor([0, 0, 4, 4])
    padded = torch.cat([q.float(), q.new_zeros(1, C, dtype=torch.float32)])
    return padded[torch.where(r < N, r, N), col].flatten()


def stage_kv_plain(k: torch.Tensor, v: torch.Tensor, tile: int, wg: int):
    """The shared-memory images warpgroup ``wg`` writes for key tile ``tile``
    of one image's k, v [N, C]: the tile's K chunks, then its V chunks, each
    a float32 tensor [2, floats] of the hi and the lo plane
    (``ops/tf32.py::split_tf32``: the values the tensor cores read); keys
    past N read as zeros. Thread wtid of the warpgroup writes, as the kernel:

    * K chunk i (keys x channels wg C/2 + i K_CHUNK + [0, K_CHUNK)): for
      e = wtid + 128 m (m = 0, 1) the four channels (e // 64) 8 +
      (e // 8 % 2) 4 + (0..3) of key (e // 16 % 4) 8 + e % 8 to floats
      4e .. 4e + 3;
    * V chunk c (keys (c % 2) V_KEYS + [0, V_KEYS) x columns wg C/2 +
      (c // 2) V_CHUNK + n): with n = wtid % 64 and h = wtid // 64, for
      m = 0, 1 the chunk's keys 8m + h + 2i (i = 0..3) of column n to the
      float4 at 2 V_CHUNK m + ((n // 8) 2 + h) 8 + n % 8."""
    N, C = k.shape
    half = C // 2
    keys = tile * KEY_TILE + torch.arange(KEY_TILE)
    inside = keys < N

    def rows(x):
        out = torch.zeros(KEY_TILE, C, dtype=torch.float32)
        out[inside] = x[keys[inside]].float()
        return out

    kt, vt = rows(k), rows(v)
    wtid = torch.arange(128)
    comp = torch.arange(4)
    chunks = []
    for i in range(half // K_CHUNK):
        e = torch.cat([wtid, wtid + 128])
        key = ((e // 16) % 4) * 8 + e % 8
        ch = wg * half + i * K_CHUNK + (e // 64) * 8 + ((e // 8) % 2) * 4
        at = 4 * e.view(-1, 1) + comp
        chunks.append(_plane_pair(at, kt[key.view(-1, 1), ch.view(-1, 1) + comp],
                                  KEY_TILE * K_CHUNK))
    n, h = wtid % 64, wtid // 64
    m = torch.arange(V_KEYS // 8).view(-1, 1)
    slot = 2 * V_CHUNK * m + ((n // 8) * 2 + h) * 8 + n % 8            # [2, 128]
    key = (8 * m + h).unsqueeze(-1) + 2 * comp                        # [2, 128, 4]
    for c in range(half // V_CHUNK * (KEY_TILE // V_KEYS)):
        col = (wg * half + (c // 2) * V_CHUNK + n).view(1, -1, 1)
        vals = vt[(c % 2) * V_KEYS + key, col]
        chunks.append(_plane_pair(4 * slot.unsqueeze(-1) + comp, vals, V_CHUNK * V_KEYS))
    return chunks


def _plane_pair(at: torch.Tensor, vals: torch.Tensor, floats: int) -> torch.Tensor:
    """[2, floats]: the hi and lo parts of ``vals`` at the float indices
    ``at``; a float nobody writes stays NaN."""
    out = torch.full((2, floats), float("nan"))
    hi, lo = split_tf32(vals.contiguous())
    out[0, at.flatten()] = hi.flatten()
    out[1, at.flatten()] = lo.flatten()
    return out


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
