"""The nearest-codeword kernel K1's design, held on the CPU through its numpy
model (``tests/vq_model.py``): the single rounding of its FFMA, the lanes'
strict-'<' scans of their slices of the codebook and the shuffle butterfly
that joins them (the first minimum must win, exact ties across slices
included), the kernel's arithmetic against the plain version and the JAX
package's XLA reference, the partition of the rows over threads and the
rule that picks the rows a thread holds, the strided read of the NCHW
latent, and the quantizer that calls it against the flax one. The CUDA
kernel itself is held to the same model on the card
(``tests/test_torch_cuda.py``)."""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
import vq_model
from dc_vic_tpu_torch.ops import vq

# the port's VQ shapes: training (batch 6 of 256x256), batch 4 of 768x512,
# the tiled 2048x1365 canvas, the contract's batch 16 of 768x512
PATH_ROWS = (6144, 24576, 45056, 98304)
H100_SMS = 132


def _f32_nearest(exact: Fraction) -> np.float32:
    """float32 nearest to ``exact``, ties to even, by exact comparison."""
    x = np.float32(float(exact))
    cands = [np.nextafter(x, np.float32(-np.inf)), x, np.nextafter(x, np.float32(np.inf))]
    gaps = [abs(Fraction(float(c)) - exact) for c in cands]
    best = min(gaps)
    ties = [c for c, g in zip(cands, gaps) if g == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def test_fma32_rounds_once():
    """The model's FFMA equals a * b + c rounded once to float32, also
    where rounding the float64 sum first would round twice (sums a hair off
    a float32 midpoint)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(400).astype(np.float32)
    b = rng.standard_normal(400).astype(np.float32)
    c = rng.standard_normal(400).astype(np.float32)
    # c = 1 + 2^-23 and a b = -2^-24 + 2^-60: the exact sum lies a hair above
    # the midpoint 1 + 2^-24 and rounds up; the float64 sum is that midpoint,
    # which would round to even (down). Then an exact midpoint (to even) and
    # an exact sum.
    one, tiny = np.float32(1.0), np.float32(2.0 ** -24)
    a = np.concatenate([a, [2.0 ** -12 * (1 + 2.0 ** -18), one, -one]]).astype(np.float32)
    b = np.concatenate([b, [-2.0 ** -12 * (1 - 2.0 ** -18), tiny, tiny]]).astype(np.float32)
    c = np.concatenate([c, [1 + 2.0 ** -23, one, one]]).astype(np.float32)
    got = vq_model.fma32(a, b, c)
    want = [_f32_nearest(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(w)))
            for x, y, w in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    assert got[-3] == np.float32(1 + 2.0 ** -23)            # up, not to even
    assert (np.float64(a[-3]) * b[-3] + c[-3]).astype(np.float32) == one   # two roundings
    assert got[-2] == one                                    # the midpoint: to even
    assert got[-1] == np.float32(1 - 2.0 ** -24)


@pytest.mark.parametrize("N", [1, 3, 4, 7, 256, 1037])
@pytest.mark.parametrize("levels", [3, 1000])
def test_lane_scan_and_butterfly_give_the_first_minimum(N, levels):
    """On distances with many exact ties (``levels`` values) the lanes'
    scans joined by the butterfly pick what np.argmin picks: the first
    minimum of the row, across lanes and in a ragged last round."""
    rng = np.random.default_rng(N * levels)
    dist = rng.integers(0, levels, (301, N)).astype(np.float32)
    got = vq_model.butterfly(*vq_model.lane_scan(dist))
    np.testing.assert_array_equal(got, np.argmin(dist, axis=1))


def _cases():
    rng = np.random.default_rng(1)
    cb = (rng.standard_normal((256, 4)) * 0.05).astype(np.float32)
    ties = cb.copy()
    # exact duplicates in other lanes' slices (n mod LANES differs) and in
    # the same slice; every row that hits one of them is an exact tie
    ties[100], ties[255], ties[13], ties[12] = ties[7], ties[0], ties[6], ties[4]
    near = cb.copy()
    near[201] = np.nextafter(near[30], np.float32(1))        # one ulp away
    near[202] = near[30] * np.float32(1 + 1e-7)
    rows = (rng.standard_normal((1037, 4)) * 0.05).astype(np.float32)
    return {
        "random": (rows, cb),
        "exact ties across slices": (np.repeat(ties, 4, axis=0), ties),
        "near ties": (np.concatenate([np.repeat(near[[30, 201, 202]], 40, axis=0),
                                      near[[30, 201, 202]] + 1e-8]).astype(np.float32), near),
        "N = 1000": (rows, (rng.standard_normal((1000, 4)) * 0.05).astype(np.float32)),
        "N = 1037 (ragged over the lanes)": (
            rows[:515], (rng.standard_normal((1037, 4)) * 0.05).astype(np.float32)),
        "N = 2": (rows[:7], cb[:2]),
    }


def _near_tie_ok(z, cb, got, want):
    """Rows where the indices differ must be near ties: the exact (float64)
    distances of the two picks within 1e-6 max(1, |d|), the rule of
    chip_smoke.py's check_vq."""
    z64, cb64 = z.astype(np.float64), cb.astype(np.float64)
    dist = (cb64 ** 2).sum(1)[None] - 2 * z64 @ cb64.T
    rows = np.arange(len(z))
    d_got, d_want = dist[rows, got], dist[rows, want]
    bad = got != want
    assert not (bad & (np.abs(d_got - d_want) >= 1e-6 * np.maximum(1, np.abs(d_want)))).any()
    return int(bad.sum())


@pytest.mark.parametrize("case", list(_cases()))
def test_kernel_model_against_plain_and_xla(case):
    """The kernel's arithmetic and partition against ``vq_argmin_plain`` and
    the JAX package's ``_vq_argmin_xla``: equal but for near ties (the
    kernel rounds -2 z . e + ||e||^2 in another order); exact duplicates
    go to the lower index."""
    from dc_vic_tpu.ops.vq import _vq_argmin_xla
    z, cb = _cases()[case]
    got = vq_model.kernel_argmin(z, cb)
    plain = vq.vq_argmin_plain(torch.from_numpy(z), torch.from_numpy(cb)).numpy()
    xla = np.asarray(_vq_argmin_xla(jnp.asarray(z), jnp.asarray(cb)))
    _near_tie_ok(z, cb, got, plain)
    _near_tie_ok(z, cb, got, xla)
    if case == "exact ties across slices":
        np.testing.assert_array_equal(got, plain)
        for dup, first in ((100, 7), (255, 0), (13, 6), (12, 4)):
            assert (got[dup * 4:dup * 4 + 4] == first).all()
    if case == "random":
        np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("M", [1, 31, 1037, *PATH_ROWS[:2]])
@pytest.mark.parametrize("R", [1, 2, 4])
def test_thread_rows_cover_every_row_once(M, R):
    """Each row under M belongs to exactly one row group of one block, and
    the LANES threads of a group hold the same rows."""
    table = vq_model.thread_rows(M, R)
    lead = [r for (b, t), rows in table.items() if t % vq.LANES == 0 for r in rows]
    assert sorted(lead) == list(range(M))
    for (b, t), rows in table.items():
        assert rows == table[b, t - t % vq.LANES]


def test_rows_per_thread_fills_the_card():
    """On an H100's 132 SMs: training's M takes one row a thread and still
    fills every SM; batch 4 two, the tiled canvas and the contract four;
    wherever R > 1 every SM gets two blocks at least."""
    got = [vq.rows_per_thread(M, H100_SMS) for M in PATH_ROWS]
    assert got == [1, 2, 4, 4]
    for M, R in zip(PATH_ROWS, got):
        blocks = -(-M // (vq.THREADS // vq.LANES * R))
        assert blocks >= (2 * H100_SMS if R > 1 else H100_SMS)
    assert vq.rows_per_thread(10, H100_SMS) == 1


def _latent(B, H, W, seed, layout):
    base = torch.from_numpy(
        (np.random.default_rng(seed).standard_normal((B, 4, H, W + 3)) * 0.05).astype(np.float32))
    if layout == "contiguous":
        return base[..., :W].contiguous()
    if layout == "channels_last":
        return base[..., :W].contiguous(memory_format=torch.channels_last)
    return base[..., 2:W + 2]                              # a slice: H and W do not merge


def _storage(t):
    """The whole float32 storage under ``t``, from its first element."""
    n = t.untyped_storage().nbytes() // 4
    return torch.empty(0).set_(t.untyped_storage(), 0, (n,)).numpy()


@pytest.mark.parametrize("layout", ["contiguous", "channels_last", "slice"])
@pytest.mark.parametrize("shape", [(3, 7, 11), (2, 1, 37), (1, 32, 32)])
def test_nchw_layout_reads_the_latent_in_place(layout, shape):
    """The strides the wrapper hands the kernel for a [B, 4, H, W] latent
    read exactly the rows of its permute to [M, 4]; a contiguous or
    channels-last latent is read where it lies (no copy), and the NCHW entry
    equals the flat entry."""
    B, H, W = shape
    z = _latent(B, H, W, sum(shape), layout)
    zl, Bl, HW, strides = vq.nchw_layout(z)
    if layout != "slice" or H == 1:
        assert zl.data_ptr() == z.data_ptr()
    rows = vq_model.gather_rows(_storage(zl), zl.storage_offset(), Bl, HW, strides)
    np.testing.assert_array_equal(rows, z.permute(0, 2, 3, 1).reshape(-1, 4).numpy())
    cb = torch.from_numpy(_cases()["random"][1])
    flat = vq.vq_argmin(z.permute(0, 2, 3, 1).reshape(-1, 4), cb).reshape(B, H, W)
    assert torch.equal(vq.vq_argmin_nchw(z, cb), flat)


def test_flat_layout_reads_the_rows():
    """The flat entry's strides read the rows of [M, 4], also of a strided
    view."""
    wide = torch.from_numpy(np.arange(40 * 6, dtype=np.float32).reshape(40, 6))
    for z in (wide[:, :4].contiguous(), wide[:, 1:5]):
        zl, B, HW, strides = vq.flat_layout(z)
        np.testing.assert_array_equal(
            vq_model.gather_rows(_storage(zl), zl.storage_offset(), B, HW, strides), z.numpy())


@pytest.mark.parametrize("shape", [(2, 6, 5), (3, 7, 9)])
def test_vector_quantizer_matches_flax(shape):
    """The quantizer's indices and straight-through latents equal the flax
    quantizer's at B > 1 with ragged H W (the K1 call site now passes the
    NCHW latent itself)."""
    import jax
    from dc_vic_tpu.models.vqgan import VectorQuantizer as J
    from dc_vic_tpu_torch.models.vqgan import VectorQuantizer
    B, H, W = shape
    rng = np.random.default_rng(B * H * W)
    z = (rng.standard_normal((B, H, W, 4)) * 0.02).astype(np.float32)
    jm = J(n_embed=64, embed_dim=4)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(z))
    tm = VectorQuantizer(64, 4)
    with torch.no_grad():
        tm.embedding.weight.copy_(torch.from_numpy(np.asarray(params["params"]["embedding"])))
        zq, idx = tm(torch.from_numpy(z).permute(0, 3, 1, 2))
    zq_j, _, idx_j = jm.apply(params, jnp.asarray(z))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(zq.permute(0, 2, 3, 1).numpy(), np.asarray(zq_j))


def test_vq_parts_patches_the_current_source():
    """The decomposition tool's anchors (``tools/vq_parts.py``) each occur
    once in the kernel's source as it stands, so every variant it builds
    drops exactly the part it names."""
    from dc_vic_tpu_torch.tools import vq_parts
    with open(vq_parts.SOURCE) as f:
        source = f.read()
    for name in vq_parts.VARIANTS:
        patched = vq_parts.variant_source(name, source)
        assert (patched == source) == (name == "kernel")
        assert "if (d < best[r])" in patched or name != "kernel"
