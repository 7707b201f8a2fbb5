"""The shared-memory layouts and the numerics of the attention kernel K2
(csrc/flash_attn_f32.cu), on the CPU.

The kernel hands the B operand of each warpgroup product to the tensor cores
as a shared-memory descriptor: a start address and two strides between core
matrices (8 rows x 16 bytes: 128 bytes between the two of a k8 step, 256
bytes between 8-row groups; tf32x3.cuh::b_descriptor). Here the images the
kernel writes (``ops/attention.py``: Q raw in the order of its A fragments;
each key tile's K chunks and transposed V chunks as the hi and lo planes
the kernel splits them into) are
read back by that descriptor arithmetic, the A fragments by the register
layout of the products (P taken from the score accumulator's layout as the
kernel takes it), and the score and value products they form must equal
the same three-product sums of the unstaged operands. Both sides sum the
same TF32 values in float64, so they agree to float64 rounding (atol = rtol
= 1e-9). Then the chain lengths the kernel uses, through
``ops/tf32.py::matmul_3xtf32``, at the score spreads chip_smoke.py holds
the kernel to float64 at. No JAX: these tests cost seconds.
"""
import numpy as np
import pytest
import torch

from dc_vic_tpu_torch.ops import attention, tf32

CORE_K_BYTES, CORE_N_BYTES = 128, 256   # tf32x3.cuh::b_descriptor
TOL64 = dict(atol=1e-9, rtol=1e-9)


def _b_operand(plane, k_step, rows):
    """The [rows x 8] K-major B operand of k8 step ``k_step`` (rows x 8
    floats each) read out of a plane through a descriptor without swizzle:
    element (n, k) lies in core matrix (n // 8, k // 4), row n % 8 of it."""
    n = np.arange(rows)[:, None]
    k = np.arange(8)[None, :]
    at = (k_step * rows * 8 * 4 + (n // 8) * CORE_N_BYTES + (k // 4) * CORE_K_BYTES
          + (n % 8) * 16 + (k % 4) * 4) // 4
    return plane[torch.from_numpy(at)].double()


def _fragment_rows():
    """(row, k) of A-fragment register x of warp w, lane: a0 (16w + g, t),
    a1 (16w + g + 8, t), a2 (16w + g, t + 4), a3 (16w + g + 8, t + 4)."""
    w = np.arange(4)[:, None, None]
    lane = np.arange(32)[None, :, None]
    x = np.arange(4)[None, None, :]
    row = 16 * w + lane // 4 + 8 * (x % 2)
    k = lane % 4 + 4 * (x // 2)
    return np.broadcast_arrays(w, lane, x, row, k)


def _a_from_q(qimg, C, step):
    """A [64 x 8] of Q's k8 step ``step`` as the kernel loads it: the float4
    slot (w * C / 8 + step) * 32 + lane of the Q image."""
    w, lane, x, row, k = _fragment_rows()
    A = torch.zeros(64, 8, dtype=torch.float64)
    slot = (w * (C // 8) + step) * 32 + lane
    A[torch.from_numpy(row), torch.from_numpy(k)] = qimg[torch.from_numpy(4 * slot + x)].double()
    return A


def _a_from_p(P, step):
    """A [64 x 8] of P's k8 step ``step`` as the kernel forms it in
    registers: the score accumulator holds d[4i + y] = P[16w + g + 8 (y // 2),
    8i + 2t + y % 2], and the fragment is (d[4i], d[4i + 2], d[4i + 1],
    d[4i + 3])."""
    w, lane, x, row, k = _fragment_rows()
    y = np.array([0, 2, 1, 3])[x]                   # which accumulator register
    p_row = 16 * w + lane // 4 + 8 * (y // 2)
    p_key = 8 * step + 2 * (lane % 4) + y % 2
    A = torch.zeros(64, 8, dtype=torch.float64)
    A[torch.from_numpy(row), torch.from_numpy(k)] = P[torch.from_numpy(p_row),
                                                      torch.from_numpy(p_key)].double()
    return A


def _three(a_hi, a_lo, b_hi, b_lo):
    """a_lo b_hi^T + a_hi b_lo^T + a_hi b_hi^T in float64 (B as [rows x k])."""
    return a_lo @ b_hi.t() + a_hi @ b_lo.t() + a_hi @ b_hi.t()


def _split64(x):
    return tuple(p.double() for p in tf32.split_tf32(x.float().contiguous()))


# (C, N, tile): every width the kernel takes; N = 1037 leaves a last tile of
# 13 keys (tile 32), and a block of 64 rows past N's end (rows 1024..1087)
CASES = [(128, 1037, 32), (256, 300, 3), (384, 1037, 0), (512, 1037, 32)]


@pytest.mark.parametrize("C,N,tile", CASES)
def test_staged_operands_form_the_score_and_value_products(C, N, tile):
    rng = np.random.default_rng(C + tile)
    q, k, v = (torch.from_numpy(rng.standard_normal((N, C)).astype(np.float32))
               for _ in range(3))
    row0 = min(1024, (N - 1) // 64 * 64)
    qimg = attention.stage_q_plain(q, row0)
    assert qimg.numel() == 64 * C and torch.isfinite(qimg).all()
    keys = tile * attention.KEY_TILE + torch.arange(attention.KEY_TILE)
    rows = row0 + torch.arange(64)
    pad = lambda x, idx: torch.where((idx < N)[:, None], x[idx.clamp(max=N - 1)], 0.0)
    q_rows, k_rows, v_rows = pad(q, rows), pad(k, keys), pad(v, keys)
    # probabilities of the tile's keys, in [0, 1] as the kernel's exp(s - m)
    P = torch.from_numpy(rng.random((64, attention.KEY_TILE)).astype(np.float32))
    P[:, (keys >= N)] = 0.0

    S = torch.zeros(64, attention.KEY_TILE, dtype=torch.float64)
    O = torch.zeros(64, C, dtype=torch.float64)
    half = C // 2
    for wg in range(2):
        chunks = attention.stage_kv_plain(k, v, tile, wg)
        n_v = half // attention.V_CHUNK * (attention.KEY_TILE // attention.V_KEYS)
        assert len(chunks) == half // attention.K_CHUNK + n_v
        for img in chunks:
            assert not torch.isnan(img).any(), "a float of a plane is never written"
        for i in range(half // attention.K_CHUNK):
            for j in range(attention.K_CHUNK // 8):
                step = wg * (C // 16) + i * (attention.K_CHUNK // 8) + j
                a_hi, a_lo = _split64(_a_from_q(qimg, C, step).float())
                b = [_b_operand(chunks[i][part], j, attention.KEY_TILE) for part in (0, 1)]
                S += _three(a_hi, a_lo, *b)
        for c in range(n_v):
            img = chunks[half // attention.K_CHUNK + c]
            col0 = wg * half + (c // 2) * attention.V_CHUNK
            cols = slice(col0, col0 + attention.V_CHUNK)
            for j in range(attention.V_KEYS // 8):   # P's k8 step (c % 2) * 2 + j
                a_hi, a_lo = _split64(_a_from_p(P, (c % 2) * (attention.V_KEYS // 8) + j).float())
                b = [_b_operand(img[part], j, attention.V_CHUNK) for part in (0, 1)]
                O[:, cols] += _three(a_hi, a_lo, *b)

    q_hi, q_lo = _split64(q_rows)
    k_hi, k_lo = _split64(k_rows)
    torch.testing.assert_close(S, _three(q_hi, q_lo, k_hi, k_lo), **TOL64)
    p_hi, p_lo = _split64(P)
    v_hi, v_lo = _split64(v_rows)
    torch.testing.assert_close(O, _three(p_hi, p_lo, v_hi.t(), v_lo.t()), **TOL64)
    if tile * attention.KEY_TILE + attention.KEY_TILE > N:
        assert (S[:, (keys >= N)] == 0).all(), "keys past N must stage as zeros"


def test_p_fragment_keys_follow_the_score_accumulator():
    """The V staging's key order inside an 8-key group (0, 2, 4, 6 | 1, 3,
    5, 7) is the order P's fragment takes from the score accumulator: P = I
    picks, at k position k of step 0, exactly key p_key_of_k(k)."""
    P = torch.eye(64, attention.KEY_TILE)
    A = _a_from_p(P, 0)
    for k in range(8):
        key = 2 * k if k < 4 else 2 * (k - 4) + 1
        assert A[key, k] == 1.0 and A[:, k].sum() == 1.0


SPREADS = {"pm60_c512": (512, 0.728), "pm500_c128": (128, 3.0), "c512": (512, None)}


@pytest.mark.parametrize("name", sorted(SPREADS))
def test_kernel_chains_hold_1e4_against_float64(name):
    """S over all C channels as chains of one K chunk (K_CHUNK channels,
    the kernel's score chain), and P V over one key tile (KEY_TILE keys, the
    value chain), each chain summed from zero and added with a rounded f32
    add, at the spreads chip_smoke.py uses: q and k x 0.728 at C = 512
    (scores over about +-60), x 3.0 at C = 128 (+-500), and q x C^-1/2 (the
    VQGAN's call)."""
    C, scale = SPREADS[name]
    rng = np.random.default_rng(sorted(SPREADS).index(name))
    q = rng.standard_normal((64, C)) * (scale if scale else C ** -0.5)
    k = rng.standard_normal((attention.KEY_TILE * 8, C)) * (scale or 1.0)
    qt, kt = torch.from_numpy(q.astype(np.float32)), torch.from_numpy(k.astype(np.float32))
    s = tf32.matmul_3xtf32(qt, kt.t().contiguous(), chain=attention.K_CHUNK)
    s64 = qt.double() @ kt.double().t()
    torch.testing.assert_close(s.double(), s64, atol=1e-4, rtol=1e-4)
    # one key tile's probabilities against its values
    p = torch.exp(s64[:, :attention.KEY_TILE] - s64.max(-1, keepdim=True).values).float()
    v = torch.from_numpy(rng.standard_normal((attention.KEY_TILE, C)).astype(np.float32))
    pv = tf32.matmul_3xtf32(p, v, chain=attention.KEY_TILE)
    torch.testing.assert_close(pv.double(), p.double() @ v.double(), atol=1e-4, rtol=1e-4)


def test_attn_stamps_instruments_the_current_source():
    """tools/attn_stamps.py finds each of its anchors once in the package's
    csrc/flash_attn_f32.cu, so the measuring build follows the kernel, and
    its count of chunks a tile is the kernel's."""
    from dc_vic_tpu_torch.tools import attn_stamps
    src = attn_stamps.instrument()
    assert src.count("g_st[wg]") == 10 and "dcvic_read_attn_stamps" in src
    for C in (128, 256, 384, 512):
        per = C // 2 // attention.K_CHUNK + C // 2 // attention.V_CHUNK * (
            attention.KEY_TILE // attention.V_KEYS)
        assert attn_stamps.chunks_per_tile(C) == per <= attn_stamps.MAX_CHUNKS
