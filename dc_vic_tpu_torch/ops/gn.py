"""GroupNorm through per-channel sums: the CUDA kernels K3 and K4
(``csrc/gn.cu``) and their plain PyTorch versions; and the fused residual
block's folded statistics, kernel ``gn_fold`` in the same file.

Port of ``dc_vic_tpu/ops/gn.py`` in the port's NCHW layout: ``channel_sums``
(K3) streams the plane once for the per-(image, channel) f32 [sum, sum of
squares], ``gn_stats`` combines them per group with the fast variance
E[x^2] - E[x]^2 clipped at zero, and ``apply_affine`` (K4) is the folded
per-(image, channel) affine with an optional swish. ``fold_stats`` is
``dc_vic_tpu/models/vqgan.py::_gn_fold``, which XLA fuses: the two-pass
variance per (image, group), folded with gamma and beta into the affine that
K6 takes, from one read of the map. Dispatch is by device: a CPU tensor takes
the ``*_plain`` version; a CUDA tensor launches the kernel or raises.
``use_kernel`` is the shape rule by which ``nn.layers.GroupNorm`` chooses
this path over its ordinary PyTorch code. All go through a
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
launches = {"gn_channel_sums": 0, "gn_apply": 0, "gn_fold": 0}
backwards = {"gn_channel_sums": 0, "gn_apply": 0, "gn_fold": 0}

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


# ------------------------------------------------------- fused statistics

def _fold_plain(x, gamma, beta, num_groups, eps):
    """(scale, bias, mean, rstd): the folded affine [B, C] and the group
    statistics [B, G] in f32 (float64 stays float64)."""
    B, C = x.shape[:2]
    xg = widen(x).reshape(B, num_groups, -1)
    mean = xg.mean(-1)
    var = torch.square(xg - mean[:, :, None]).mean(-1)
    inv = torch.rsqrt(var + eps)
    rep = lambda a: a.repeat_interleave(C // num_groups, dim=1)     # [B,G]->[B,C]
    scale = widen(gamma)[None] * rep(inv)
    bias = widen(beta)[None] - rep(mean) * scale
    return scale, bias, mean, inv


def fold_stats_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     num_groups: int, eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm statistics of x [B, C, ...] and gamma, beta folded into one
    per-(image, channel) affine: GN(x) * gamma + beta == x * scale + bias.
    Mean and two-pass variance (the mean of squared deviations) per (image,
    group) in f32; scale, bias [B, C] f32."""
    return _fold_plain(x, gamma, beta, num_groups, eps)[:2]


# tickets of the kernel's last-block merge, one per (image, group), by device
# and stream: 0 between launches (each launch sets back what it counted).
# Launches on one stream run in order, so they share one buffer; launches on
# two streams may overlap, so each stream has its own (one first made under
# graph capture is zeroed when the graph replays).
_tickets = {}


def _ticket_buffer(device: torch.device, stream: int, groups: int) -> torch.Tensor:
    buf = _tickets.get((device.index, stream))
    if buf is None or buf.numel() < groups:
        buf = _tickets[device.index, stream] = torch.zeros(groups, dtype=torch.int32,
                                                           device=device)
    return buf


def _fold_stats_cuda(x, gamma, beta, num_groups, eps):
    dtype = _check_map(x, "fold_stats")
    if gamma.dtype != beta.dtype or gamma.dtype not in _DTYPES:
        raise TypeError(f"fold_stats kernel takes float32 or bfloat16 gamma and beta, got "
                        f"{gamma.dtype} and {beta.dtype}")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("x, gamma and beta must be on the same device")
    B, C = x.shape[:2]
    x, gamma, beta = _row_major(x), gamma.contiguous(), beta.contiguous()
    HW = x.numel() // (B * C)
    lib = native.kernels()
    chunks = lib.dcvic_gn_fold_chunks((C // num_groups) * HW, dtype)
    affine = torch.empty(2, B, C, dtype=torch.float32, device=x.device)
    stats = torch.empty(2, B, num_groups, dtype=torch.float32, device=x.device)
    partials = torch.empty(2 * B * num_groups * chunks, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _ticket_buffer(x.device, stream, B * num_groups)
        err = lib.dcvic_gn_fold(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                affine[0].data_ptr(), affine[1].data_ptr(),
                                stats[0].data_ptr(), stats[1].data_ptr(), partials.data_ptr(),
                                tickets.data_ptr(), B, C, num_groups, HW, eps, dtype,
                                _DTYPES[gamma.dtype], stream)
    native.check(err, "gn_fold")
    launches["gn_fold"] += 1
    return affine[0], affine[1], stats[0], stats[1]


class _FoldStats(torch.autograd.Function):
    """``gn_fold`` forward (the plain version on the CPU); backward: the
    gradient of the plain version in closed form from the saved x and the
    forward's per-group mean and rstd."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps):
        if x.device.type == "cpu":
            scale, bias, mean, rstd = _fold_plain(x, gamma, beta, num_groups, eps)
        else:
            scale, bias, mean, rstd = _fold_stats_cuda(x, gamma, beta, num_groups, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.beta_dtype = beta.dtype
        return scale, bias

    @staticmethod
    def backward(ctx, g_scale, g_bias):
        # scale = gamma r, bias = beta - m gamma r per (image, group) with
        # r = (var + eps)^-1/2; var reaches x as 2 (x - m) / n, m as 1 / n
        x, gamma, mean, rstd = ctx.saved_tensors
        if x.device.type == "cuda":
            backwards["gn_fold"] += 1
        B, C = x.shape[:2]
        G = mean.shape[1]
        gs, gb = (g.reshape(B, G, C // G) for g in (g_scale, g_bias))
        m, r = mean[:, :, None], rstd[:, :, None]
        gam = widen(gamma).reshape(G, C // G)
        dx = d_gamma = d_beta = None
        if ctx.needs_input_grad[0]:
            n = x.numel() // (B * G)
            d_r = (gam * (gs - m * gb)).sum(-1)
            d_mean = -(gam * gb).sum(-1) * rstd
            d_var = -0.5 * rstd ** 3 * d_r
            dx = x.reshape(B, G, -1) - m                     # the one f32 map
            dx.mul_((2.0 / n) * d_var[:, :, None]).add_(d_mean[:, :, None] / n)
            dx = dx.reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:
            d_gamma = (r * (gs - m * gb)).sum(0).reshape(C).to(gamma.dtype)
        if ctx.needs_input_grad[2]:
            d_beta = gb.sum(0).reshape(C).to(ctx.beta_dtype)
        return dx, d_gamma, d_beta, None, None


def fold_stats(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               num_groups: int, eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, bias) [B, C] f32 with GN(x) * gamma + beta == x * scale +
    bias for x [B, C, H, W] f32 or bf16 (float64 on the CPU): per (image,
    group) the mean and the two-pass variance, as ``fold_stats_plain``."""
    if x.dim() != 4:
        raise ValueError(f"fold_stats: expected [B, C, H, W], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise TypeError(f"fold_stats takes float32 or bfloat16, got {x.dtype}")
    C = x.shape[1]
    if num_groups <= 0 or C % num_groups:
        raise ValueError(f"fold_stats: {C} channels in {num_groups} groups")
    if tuple(gamma.shape) != (C,) or tuple(beta.shape) != (C,):
        raise ValueError(f"fold_stats: gamma {tuple(gamma.shape)} / beta "
                         f"{tuple(beta.shape)} for {C} channels")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fold_stats: unsupported device {x.device}")
    return _FoldStats.apply(x, gamma, beta, num_groups, eps)
