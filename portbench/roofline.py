"""The yardstick's arithmetic: the H100's published peaks, the operations
and bytes of the attention and 3x3 convolution calls a cell makes (counted
from each call's shapes, whatever implements it), and the model FLOPs of a
unit of work counted from the plain reference.

Peaks (NVIDIA's H100 SXM data sheet, dense): 989 TFLOP/s bf16, 495 TFLOP/s
TF32 (an f32-class product taken as three TF32 products: 165 TFLOP/s),
3.35 TB/s HBM. A call's bound is the larger of its operations over the
peak and its bytes over the bandwidth, each input read once and each output
written once.

Which calls are counted follows the configuration's ``recon_kernels`` and
the kernels' published shape rule (channels in multiples of 128, even
sides, a plane of at least 12,288 positions and 16,384 in the batch): a
VQGAN residual block that passes it is two fused conv calls (K6), any other
3x3 stride-1 conv of the served stacks that passes it one plain conv call
(K5), and each VQGAN attention block one attention call (K2).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from torch import nn

BF16_PEAK = 989e12
TF32X3_PEAK = 495e12 / 3.0
HBM_BYTES_PER_S = 3.35e12

Call = Tuple[float, float, float]      # (operations, bytes, peak operations per second)


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


def attention_call(B: int, N: int, C: int) -> Call:
    """softmax(q k^T) v over [B, N, C] f32 operands: the two products, at
    the three-TF32 rate; q, k, v read and the output written once."""
    return 4.0 * B * N * N * C, 4.0 * 4 * B * N * C, TF32X3_PEAK


def conv3x3_call(B: int, C: int, Cout: int, H: int, W: int, esize: int, fused: bool,
                 residual: bool) -> Call:
    """A 3x3 same conv [B, C, H, W] -> Cout: 18 C Cout operations a
    position; the fused form adds its per-channel affine and swish on the
    input and the bias (and residual) on the output."""
    ops = 18.0 * C * Cout * B * H * W
    nbytes = esize * (B * C * H * W + 9 * C * Cout + B * Cout * H * W)
    if fused:
        ops += 6.0 * B * C * H * W + B * Cout * H * W
        nbytes += 4 * (2 * B * C + Cout)
    if residual:
        nbytes += esize * B * Cout * H * W
        ops += B * Cout * H * W
    peak = BF16_PEAK if esize == 2 else TF32X3_PEAK
    return ops, nbytes, peak


def kernel_rule(B: int, C: int, Cout: int, H: int, W: int) -> bool:
    return (C % 128 == 0 and Cout % 128 == 0 and H % 2 == 0 and W % 2 == 0
            and H * W >= 12288 and B * H * W >= 16384)


def count_calls(model: nn.Module, run, recon_kernels, esize: int) -> Dict[str, List[Call]]:
    """Run ``run()`` (a forward of the reference ``model``, on the meta
    device) with hooks that record its attention and 3x3 conv calls."""
    from .reference import dcvic
    calls: Dict[str, List[Call]] = {"attn": [], "conv3x3": []}
    fused_on, conv_on = "fused_resblock" in recon_kernels, "conv3x3" in recon_kernels
    skip = set()
    handles = []

    def res_pre(mod, args):
        B, C, H, W = args[0].shape
        Cout = mod.conv1.out_channels
        if fused_on and kernel_rule(B, C, Cout, H, W):
            calls["conv3x3"].append(conv3x3_call(B, C, Cout, H, W, esize, True, False))
            calls["conv3x3"].append(conv3x3_call(B, Cout, Cout, H, W, esize, True, True))
            skip.update((id(mod.conv1), id(mod.conv2)))

    def res_post(mod, args, out):
        skip.difference_update((id(mod.conv1), id(mod.conv2)))

    def conv_pre(mod, args):
        if id(mod) in skip or not conv_on or mod.kernel_size != (3, 3) or mod.stride != (1, 1):
            return
        B, C, H, W = args[0].shape
        if kernel_rule(B, C, mod.out_channels, H, W):
            calls["conv3x3"].append(conv3x3_call(B, C, mod.out_channels, H, W, esize,
                                                 False, False))

    def attn_pre(mod, args):
        B, C, H, W = args[0].shape
        calls["attn"].append(attention_call(B, H * W, C))

    for m in model.modules():
        if isinstance(m, dcvic.VQResnetBlock):
            handles += [m.register_forward_pre_hook(res_pre), m.register_forward_hook(res_post)]
        elif isinstance(m, dcvic.SConv):
            handles.append(m.register_forward_pre_hook(conv_pre))
        elif isinstance(m, dcvic.VQAttnBlock):
            handles.append(m.register_forward_pre_hook(attn_pre))
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return calls


def flops_of(run) -> float:
    """Model FLOPs of ``run()`` as ``torch.utils.flop_counter`` counts them
    (products and convolutions, forward and, where ``run`` calls it,
    backward)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        run()
    return float(counter.get_total_flops())
