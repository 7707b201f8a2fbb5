"""GroupNorm through per-channel sums: the CUDA kernels K3 and K4
(``csrc/gn.cu``) and their plain PyTorch versions.

Port of ``dc_vic_tpu/ops/gn.py`` in the port's NCHW layout: ``channel_sums``
(K3) streams the plane once for the per-(image, channel) f32 [sum, sum of
squares], ``gn_stats`` combines them per group with the fast variance
E[x^2] - E[x]^2 clipped at zero, and ``apply_affine`` (K4) is the folded
per-(image, channel) affine with an optional swish. Dispatch is by device: a
CPU tensor takes the ``*_plain`` version; a CUDA tensor launches the kernel or
raises. ``use_kernel`` is the shape rule by which ``nn.layers.GroupNorm``
chooses this path over its ordinary PyTorch code. Both go through a
``torch.autograd.Function`` (on the CPU too) whose backward is the gradient
of the plain version in PyTorch, as XLA differentiates the JAX package's
plain math.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import native
from .layout import row_major as _row_major
from .layout import widen

# Kernel launches since the last reset (counted where each kernel launches),
# and backward passes of the Functions on CUDA tensors (PyTorch, no kernel).
launches = {"gn_channel_sums": 0, "gn_apply": 0}
backwards = {"gn_channel_sums": 0, "gn_apply": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = (None, "swish")


def use_kernel(shape: Sequence[int]) -> bool:
    """The JAX package's rule for its GroupNorm kernels, without its backend
    test and its row-bytes cap (a limit of TPU tile memory, not of the
    function): a 4-D map with C % 128 == 0 and a plane of at least 2048
    positions."""
    if len(shape) != 4:
        return False
    _, C, H, W = shape
    return C % 128 == 0 and H * W >= 2048


def _check_map(x: torch.Tensor, what: str) -> int:
    if x.dim() < 3:
        raise ValueError(f"{what}: expected [B, C, ...], got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"{what}: empty input {tuple(x.shape)}")
    return _DTYPES[x.dtype]


# ------------------------------------------------------------------- K3

def channel_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """Per-(image, channel) [sum, sum of squares] of x [B, C, ...] in f32:
    [B, 2, C]."""
    xf = widen(x).reshape(x.shape[0], x.shape[1], -1)
    return torch.stack([xf.sum(-1), (xf * xf).sum(-1)], dim=1)


def _channel_sums_cuda(x: torch.Tensor) -> torch.Tensor:
    dtype = _check_map(x, "channel_sums")
    B, C = x.shape[:2]
    x = _row_major(x)
    out = torch.empty(B, 2, C, dtype=torch.float32, device=x.device)
    lib = native.kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcvic_gn_channel_sums(x.data_ptr(), out.data_ptr(), B, C,
                                        x.numel() // (B * C), dtype, stream)
    native.check(err, "gn_channel_sums")
    launches["gn_channel_sums"] += 1
    return out


class _ChannelSums(torch.autograd.Function):
    """K3 forward (the plain version on the CPU); backward: d sum = g0,
    d sum of squares = 2 x g1, per (image, channel)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.device.type == "cpu":
            return channel_sums_plain(x)
        return _channel_sums_cuda(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        if x.device.type == "cuda":
            backwards["gn_channel_sums"] += 1
        g = _per_channel(g, x)                                # [B, 2, C, 1, ...]
        return (g[:, 0] + 2.0 * widen(x) * g[:, 1]).to(x.dtype)


def channel_sums(x: torch.Tensor) -> torch.Tensor:
    """Per-(image, channel) [sum, sum of squares] of x [B, C, ...], f32
    [B, 2, C]."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"channel_sums: unsupported device {x.device}")
    return _ChannelSums.apply(x)


# ------------------------------------------------------------------- K4

def _per_channel(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape + (1,) * (x.dim() - 2))


def apply_affine_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       act: Optional[str] = None) -> torch.Tensor:
    """act(x * scale[b, c] + bias[b, c]) in f32, cast back to x's type."""
    y = widen(x) * _per_channel(widen(scale), x) + _per_channel(widen(bias), x)
    if act == "swish":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _apply_affine_cuda(x, scale, bias, act):
    dtype = _check_map(x, "apply_affine")
    B, C = x.shape[:2]
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("apply_affine kernel takes float32 scale and bias")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("x, scale and bias must be on the same device")
    x, scale, bias = _row_major(x), _row_major(scale), _row_major(bias)
    out = torch.empty_like(x)
    lib = native.kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dcvic_gn_apply(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), B, C, x.numel() // (B * C), dtype,
                                 int(act == "swish"), stream)
    native.check(err, "gn_apply")
    launches["gn_apply"] += 1
    return out


class _ApplyAffine(torch.autograd.Function):
    """K4 forward (the plain version on the CPU); backward: autograd of
    ``apply_affine_plain`` on the saved inputs (elementwise recomputation)."""

    @staticmethod
    def forward(ctx, x, scale, bias, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.act = act
        if x.device.type == "cpu":
            return apply_affine_plain(x, scale, bias, act)
        return _apply_affine_cuda(x, scale, bias, act)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        if x.device.type == "cuda":
            backwards["gn_apply"] += 1
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((x, scale, bias), ctx.needs_input_grad)]
        with torch.enable_grad():
            y = apply_affine_plain(*inputs, ctx.act)
            want = [t for t in inputs if t.requires_grad]
            got = iter(torch.autograd.grad(y, want, g))
        return tuple(next(got) if t.requires_grad else None for t in inputs) + (None,)


def apply_affine(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 act: Optional[str] = None) -> torch.Tensor:
    """act(x * scale[b, c] + bias[b, c]) for x [B, C, ...] and scale, bias
    [B, C] f32; act is None or 'swish'. Returns x's type."""
    if act not in _ACTS:
        raise ValueError(f"apply_affine: unknown act {act!r}")
    if tuple(scale.shape) != tuple(x.shape[:2]) or scale.shape != bias.shape:
        raise ValueError(f"apply_affine: scale {tuple(scale.shape)} / bias "
                         f"{tuple(bias.shape)} for x {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"apply_affine: unsupported device {x.device}")
    return _ApplyAffine.apply(x, scale, bias, act)


# ------------------------------------------------------------ GroupNorm

def gn_stats(x: torch.Tensor, num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) per (image, group) of x [B, C, ...], both [B, G] f32.
    Fast variance, clipped at zero."""
    B, C = x.shape[:2]
    n = (x.numel() // (B * C)) * (C // num_groups)
    g = channel_sums(x).reshape(B, 2, num_groups, C // num_groups).sum(-1)
    mean = g[:, 0] / n
    var = torch.clamp(g[:, 1] / n - mean * mean, min=0.0)
    return mean, var


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               num_groups: int, epsilon: float = 1e-6,
               act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm over (within-group C, spatial) of x [B, C, ...] with an
    optional fused activation (act='swish'); returns x's type. Statistics
    through ``channel_sums``; the apply folds to a per-(image, channel)
    affine."""
    B, C = x.shape[:2]
    mean, var = gn_stats(x, num_groups)
    inv = torch.rsqrt(var + epsilon)
    rep = lambda a: a.repeat_interleave(C // num_groups, dim=1)     # [B,G]->[B,C]
    scale = gamma.float()[None] * rep(inv)
    bias = beta.float()[None] - rep(mean) * scale
    return apply_affine(x, scale, bias, act)
