"""The operand layouts of the bf16 3x3 conv kernels (csrc/conv3x3_bf16.cu),
on the CPU.

The kernels hand both operands of each wgmma to the tensor cores as shared-
memory descriptors: a start address and two strides between core matrices
(8 rows x 16 bytes, 128 contiguous bytes), one along K and one along M or N.
Here the staged input tile and the repacked weights are built as flat bf16
buffers in the kernels' layouts, the operands are read out of them by that
descriptor arithmetic, tap by tap and 16 input channels at a time, and the
implicit GEMM they form must equal F.conv2d. The products are of bf16 values
and sums run in float64 on both sides, so they agree to float64 rounding
(atol = rtol = 1e-9).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dc_vic_tpu_torch.ops import conv3x3

# the kernels' tile: 4 output rows x 64 columns x 128 output channels, 16
# input channels a step, staged rows and columns with a one-pixel halo
TH, TW, TCO, KC = 4, 64, 128, 16
XROWS, XCOLS = TH + 2, TW + 2
XPLANE = XROWS * XCOLS
ELEM = 2   # bytes of a bf16


def _core_matrix_rows(start, k_bytes, mn_bytes, rows):
    """Byte offsets of a [rows x 16] K-major operand read through a
    descriptor without swizzle: element (m, k) lies in core matrix
    (m // 8, k // 8), row m % 8 of it, at 16 bytes a row."""
    m = np.arange(rows)[:, None]
    k = np.arange(KC)[None, :]
    return start + (m // 8) * mn_bytes + (k // 8) * k_bytes + (m % 8) * 16 + (k % 8) * ELEM


def _stage_input(x, b, c0, h0, w0):
    """The staged input of one step as the kernel writes it: [channel group
    (2)][row (6)][column (66)][8 channels], zeros outside the image; flat."""
    _, _, H, W = x.shape
    tile = torch.zeros(2, XROWS, XCOLS, 8, dtype=x.dtype)
    for r in range(XROWS):
        for col in range(XCOLS):
            gh, gw = h0 - 1 + r, w0 - 1 + col
            if 0 <= gh < H and 0 <= gw < W:
                tile[:, r, col] = x[b, c0:c0 + KC, gh, gw].reshape(2, 8)
    return tile.flatten()


def _implicit_gemm(x, wt, Cout):
    """out [B, Cout, H, W] from the staged tiles and the repacked weights,
    each operand read by descriptor arithmetic; float64 sums."""
    B, C, H, W = x.shape
    n8s = wt.shape[2]
    out = torch.zeros(B, n8s * 8, H, W, dtype=torch.float64)
    for b in range(B):
        for h0 in range(0, H, TH):
            for w0 in range(0, W, TW):
                for co0 in range(0, n8s * 8, TCO):
                    acc = torch.zeros(TH, TW, TCO, dtype=torch.float64)
                    for s in range(C // KC):
                        xs = _stage_input(x, b, s * KC, h0, w0)
                        # the step's slab: nine runs of the block's 16 n8 groups
                        slab = wt[s, :, co0 // 8:co0 // 8 + TCO // 8].flatten()
                        for tap in range(9):
                            b_at = _core_matrix_rows(tap * TCO * KC * ELEM, 128, 256, TCO)
                            B_op = slab[torch.from_numpy(b_at // ELEM)].double()
                            for row in range(TH):
                                a_start = ((row + tap // 3) * XCOLS + tap % 3) * 16
                                a_at = _core_matrix_rows(a_start, XPLANE * 16, 128, TW)
                                A_op = xs[torch.from_numpy(a_at // ELEM)].double()
                                acc[row] += A_op @ B_op.t()
                    rows, cols = min(TH, H - h0), min(TW, W - w0)
                    out[b, co0:co0 + TCO, h0:h0 + rows, w0:w0 + cols] = \
                        acc[:rows, :cols].permute(2, 0, 1)
    return out[:, :Cout]


def _case(seed, B, C, Cout, H, W):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, C, H, W)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((Cout, C, 3, 3)) * 0.05).astype(np.float32))
    return x.to(torch.bfloat16), w.to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(1, 16, 128, 4, 64),     # one tile, one step
                                   (1, 32, 192, 5, 70),     # ragged H and W, padded Cout
                                   (2, 48, 64, 3, 9)])      # three steps, Cout under a tile
def test_implicit_gemm_from_the_repacked_layout_equals_conv2d(shape):
    B, C, Cout, H, W = shape
    x, w = _case(0, B, C, Cout, H, W)
    wt = conv3x3.repack_weights_bf16_plain(w)
    got = _implicit_gemm(x, wt, Cout)
    want = F.conv2d(x.double(), w.double(), padding=1)
    torch.testing.assert_close(got, want, atol=1e-9, rtol=1e-9)


def test_repacked_weights_place_each_value_and_pad_with_zeros():
    """Element (c16, tap, n8, half, r, k) is w[n8 * 8 + r, c16 * 16 + half *
    8 + k, tap // 3, tap % 3]; output channels beyond Cout are zero, and the
    CPU route of the repack is the plain version."""
    _, w = _case(1, 1, 32, 192, 1, 1)
    wt = conv3x3.repack_weights_bf16_plain(w)
    assert wt.shape == (2, 9, 32, 2, 8, 8) and wt.dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    for c16, tap, n8, half, r, k in zip(*(rng.integers(0, n, 50) for n in (2, 9, 24, 2, 8, 8))):
        assert wt[c16, tap, n8, half, r, k] == w[n8 * 8 + r, c16 * 16 + half * 8 + k,
                                                 tap // 3, tap % 3]
    assert not wt[:, :, 24:].any()
    assert torch.equal(conv3x3.repack_weights_bf16(w), wt)
