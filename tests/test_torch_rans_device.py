"""The port's tpu-format coder on the CPU: its plain PyTorch versions
against the JAX device coder and against the port's host coder, on the same
symbols, indexes and tables made from a seed with numpy. Everything here is
integers, so every comparison is exact (coded_bits: 1e-3 bits)."""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dc_vic_tpu.ops import rans_device as jrd
from dc_vic_tpu.ops.rans import CdfTable as JaxCdfTable
from dc_vic_tpu_torch.ops import rans_device as rd
from dc_vic_tpu_torch.ops.rans_host import tpu_decode_stream, tpu_encode_sections

SCALES = (0.5, 1.0, 4.0, 16.0)


def _seed(*parts):
    return zlib.crc32(repr(parts).encode())


def _gaussian_tables():
    from dc_vic_tpu_torch.codec.gaussian import GaussianConditional
    host = GaussianConditional().build_cdf_table(np.asarray(SCALES))
    return host, JaxCdfTable(host.cdfs, host.cdf_lengths, host.offsets)


def _bottleneck_tables(channels=8, half_width=None):
    """A z-style table: one row per channel, from a factorised bottleneck
    with seeded weights; ``half_width`` sets the quantiles that far either
    side of the median (a wide z, as training can leave it)."""
    from dc_vic_tpu_torch.codec.bottleneck import EntropyBottleneck, build_bottleneck_cdf
    from dc_vic_tpu_torch.models import init_weights
    eb = EntropyBottleneck(channels)
    init_weights(eb, torch.Generator().manual_seed(3))
    if half_width is not None:
        with torch.no_grad():
            eb.quantiles[:, 0, 0] = eb.quantiles[:, 0, 1] - half_width
            eb.quantiles[:, 0, 2] = eb.quantiles[:, 0, 1] + half_width
    host = build_bottleneck_cdf(eb)
    return host, JaxCdfTable(host.cdfs, host.cdf_lengths, host.offsets)


@pytest.fixture(scope="module")
def gaussian():
    host, jax_host = _gaussian_tables()
    return host, rd.DeviceCdfTable(host, "cpu"), jrd.DeviceCdfTable(jax_host)


@pytest.fixture(scope="module")
def bottleneck():
    host, jax_host = _bottleneck_tables()
    return host, rd.DeviceCdfTable(host, "cpu"), jrd.DeviceCdfTable(jax_host)


@pytest.fixture(scope="module")
def wide():
    """192 channels of 323 bins: more pair entries than kernel R2 copies
    into shared memory (45,056), so on the card it reads them in place."""
    host, _ = _bottleneck_tables(192, 160)
    return host, rd.DeviceCdfTable(host, "cpu"), None


def _symbols(rng, kind, shape, rows, mix):
    """Symbols and CDF rows [B, N]. mix: "inrange" (Gaussian draws of each
    row's scale, or small draws for the bottleneck), "tier1" (15% of
    symbols up to +-20000: one side-channel word each), "tier2" (some up
    to +-40000: the zigzag payload passes 0xFFFF)."""
    B, N = shape
    if kind == "gaussian":
        idx = rng.integers(0, rows, (B, N))
        sym = np.round(rng.normal(0, np.asarray(SCALES)[idx]))
    else:
        idx = np.broadcast_to(np.arange(N) % rows, (B, N)).copy()
        sym = rng.integers(-4, 5, (B, N))
    if mix in ("tier1", "tier2"):
        hot = rng.random((B, N)) < 0.15
        sym = np.where(hot, rng.integers(-20000, 20000, (B, N)), sym)
    if mix == "tier2":
        hot = rng.random((B, N)) < 0.05
        sym = np.where(hot, rng.integers(-40000, 40000, (B, N)), sym)
        sym[0, 1], sym[-1, -2] = 40000, -40000
    return sym.astype(np.int32), idx.astype(np.int32)


def _sections(sym, idx, n_sections, L):
    B, N = sym.shape
    ns = N // n_sections
    return [(sym[:, s * ns:(s + 1) * ns].reshape(B, -1, L),
             idx[:, s * ns:(s + 1) * ns].reshape(B, -1, L)) for s in range(n_sections)]


def _torch_streams(secs, table):
    vals, mask, esc, big = rd.encode_stream_plain(
        [(torch.from_numpy(s), torch.from_numpy(i)) for s, i in secs], table)
    packed, counts = rd.pack_streams_plain(vals, mask)
    counts = counts.numpy()
    words = packed.numpy().view(np.uint16)[:int(counts.sum())]
    return words, counts, esc.numpy(), big.numpy()


def _jax_streams(secs, table):
    vals, mask, esc = jrd.encode_stream(
        [(jnp.asarray(s), jnp.asarray(i)) for s, i in secs], table,
        clipped=False, with_esc_counts=True)
    packed, counts = jrd.pack_streams(vals, mask)
    counts = np.asarray(counts)
    return np.asarray(packed)[:int(counts.sum())], counts, np.asarray(esc)


@pytest.mark.parametrize("cap", [4, 128, 512])
@pytest.mark.parametrize("n_sections", [1, 3])
@pytest.mark.parametrize("mix", ["inrange", "tier1", "tier2"])
@pytest.mark.parametrize("kind", ["gaussian", "bottleneck"])
def test_encode_bytes_equal_jax_and_host_coder(request, kind, mix, n_sections, cap):
    """Plain encode_stream + pack_streams write the bytes of the JAX device
    coder and of the port's host coder; escape counts and the tier-2 flag
    agree too."""
    host, table, jax_table = request.getfixturevalue(kind)
    rng = np.random.default_rng(_seed(kind, mix, n_sections, cap))
    B, N = 2, 3 * 2048
    sym, idx = _symbols(rng, kind, (B, N), table.rows, mix)
    L = rd.section_lanes(N // n_sections, cap)
    assert L == jrd.section_lanes(N // n_sections, cap)
    secs = _sections(sym, idx, n_sections, L)
    words, counts, esc, big = _torch_streams(secs, table)
    jwords, jcounts, jesc = _jax_streams(secs, jax_table)
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(words, jwords)
    np.testing.assert_array_equal(esc, jesc)
    base = np.concatenate([[0], np.cumsum(counts)])
    for b in range(B):
        data, esc_max, has_t2 = tpu_encode_sections(
            [(s[b], i[b]) for s, i in secs], host, return_esc_max=True)
        assert data == words[base[b]:base[b + 1]].tobytes()
        assert esc_max == esc[b].max() and has_t2 == bool(big[b] > 0)
    assert bool(big.sum()) == (mix == "tier2")
    assert mix == "inrange" or esc.sum() > 0


@pytest.mark.parametrize("cap", [4, 128, 512])
@pytest.mark.parametrize("mix", ["inrange", "tier1", "tier2"])
@pytest.mark.parametrize("kind", ["gaussian", "bottleneck"])
def test_decode_equals_jax_and_host_coder(request, kind, mix, cap):
    """Plain decode_section against the JAX decode_section over a chained
    three-section stream: symbols, cursor and lane states after every
    section; the host decoder reads the same stream; all lanes end at 2^16."""
    host, table, jax_table = request.getfixturevalue(kind)
    rng = np.random.default_rng(_seed(kind, mix, cap, "dec"))
    B, N, n_sections = 2, 3 * 2048, 3
    sym, idx = _symbols(rng, kind, (B, N), table.rows, mix)
    L = rd.section_lanes(N // n_sections, cap)
    secs = _sections(sym, idx, n_sections, L)
    words, counts, _, _ = _torch_streams(secs, table)
    base = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    tw, tb = torch.from_numpy(words.view(np.int16).copy()), torch.from_numpy(base)
    cur, state = torch.zeros(B, dtype=torch.int32), None
    jcur, jstate = jnp.zeros((B,), jnp.int32), None
    for s, i in secs:
        got, cur, state = rd.decode_section_plain(tw, tb, cur, state, torch.from_numpy(i), table)
        want, jcur, jstate = jrd.decode_section(jnp.asarray(words), jnp.asarray(base), jcur,
                                                jstate, jnp.asarray(i), jax_table)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), s)
        np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur))
        np.testing.assert_array_equal(state.numpy().view(np.uint32), np.asarray(jstate))
    np.testing.assert_array_equal(cur.numpy(), counts)
    assert (state.numpy().view(np.uint32) == 1 << 16).all()
    for b in range(B):
        stream = words[base[b]:base[b] + counts[b]]
        dec, used = tpu_decode_stream(stream, [i[b] for _, i in secs], host)
        assert used == counts[b]
        for (s, _), d in zip(secs, dec):
            np.testing.assert_array_equal(d, s[b])


def test_section_lanes_and_esc_cap_equal_jax():
    for n in list(range(1, 300)) + [352, 512, 3072, 18432, 49152, 131072, 1 << 20]:
        assert rd.esc_cap(n) == jrd.esc_cap(n)
        for cap in (1, 2, 4, 8, 32, 128, 512, 4096):
            assert rd.section_lanes(n, cap) == jrd.section_lanes(n, cap), (n, cap)
    assert rd.section_lanes(49152) == 128 and rd.section_lanes(18432) == 128
    assert rd.section_lanes(49152, 512) == 512 and rd.section_lanes(192) == 8
    assert (rd.PRECISION, rd.RANS_L, rd.LANES, rd.TIER1_MARKER, rd.ESC_POISON) == (
        jrd.PRECISION, jrd.RANS_L, jrd.LANES, jrd.TIER1_MARKER, jrd.ESC_POISON)


@pytest.mark.parametrize("kind,mix", [("gaussian", "inrange"), ("gaussian", "tier2"),
                                      ("bottleneck", "tier1")])
def test_coded_bits_equal_jax(request, kind, mix):
    _, table, jax_table = request.getfixturevalue(kind)
    sym, idx = _symbols(np.random.default_rng(5), kind, (3, 256), table.rows, mix)
    got = rd.coded_bits(torch.from_numpy(sym), torch.from_numpy(idx), table).numpy()
    want = np.asarray(jrd.coded_bits(jnp.asarray(sym), jnp.asarray(idx), jax_table))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def _one_stream(table, sym, idx, L):
    words, counts, _, _ = _torch_streams(_sections(sym, idx, 1, L), table)
    base = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return (torch.from_numpy(words.view(np.int16).copy()), torch.from_numpy(base), counts)


@pytest.mark.parametrize("case", ["escfree", "t2free", "esc_cap"])
def test_violated_guarantee_poisons_the_cursor(gaussian, case):
    """Image 1 breaks the guarantee the flag states and its cursor gets
    ESC_POISON; image 0 keeps it and decodes exactly, as in the JAX coder."""
    _, table, jax_table = gaussian
    rng = np.random.default_rng(12)
    B, N = 2, 2048
    idx = rng.integers(0, 4, (B, N)).astype(np.int32)
    sym = np.zeros((B, N), np.int32)
    flags = dict(escfree=dict(escfree=True), t2free=dict(tier2=False),
                 esc_cap=dict(sparse_esc=True))[case]
    if case == "escfree":
        sym[1, 5] = 300
    elif case == "t2free":
        sym[0, 9] = 300          # a tier-1 escape is within the guarantee
        sym[1, 7] = 50000
    else:
        assert rd.esc_cap(N) < N
        sym[0, 9] = 300
        sym[1] = rng.integers(1000, 3000, N)
    L = rd.section_lanes(N)
    words, base, counts = _one_stream(table, sym, idx, L)
    got, cur, _ = rd.decode_section_plain(words, base, torch.zeros(B, dtype=torch.int32), None,
                                          torch.from_numpy(idx.reshape(B, -1, L)), table, **flags)
    _, jcur, _ = jrd.decode_section(jnp.asarray(words.numpy().view(np.uint16)),
                                    jnp.asarray(base.numpy()), jnp.zeros((B,), jnp.int32), None,
                                    jnp.asarray(idx.reshape(B, -1, L)), jax_table, **flags)
    assert int(cur[1]) >= rd.ESC_POISON and int(np.asarray(jcur)[1]) >= rd.ESC_POISON
    assert int(cur[0]) == counts[0] == int(np.asarray(jcur)[0])
    np.testing.assert_array_equal(got[0].numpy().reshape(-1), sym[0])


def test_truncated_stream_reads_zero_words_and_overruns(gaussian):
    """Reads past the buffer give 0 and never fault; the cursor then
    disagrees with the stream's length."""
    _, table, _ = gaussian
    sym, idx = _symbols(np.random.default_rng(2), "gaussian", (1, 1024), 4, "tier1")
    L = rd.section_lanes(1024)
    words, base, counts = _one_stream(table, sym, idx, L)
    cut = words[:counts[0] // 2].clone()
    got, cur, _ = rd.decode_section_plain(cut, base, torch.zeros(1, dtype=torch.int32), None,
                                          torch.from_numpy(idx.reshape(1, -1, L)), table)
    assert got.shape == (1, 1024 // L, L) and int(cur[0]) != cut.numel()
    empty = torch.zeros(0, dtype=torch.int16)
    _, cur, _ = rd.decode_section_plain(empty, base, torch.zeros(1, dtype=torch.int32), None,
                                        torch.from_numpy(idx.reshape(1, -1, L)), table)
    assert int(cur[0]) > 0


def test_stream_order_is_the_nhwc_flatten():
    """to_stream / from_stream against an explicit NHWC flatten: position
    p = (h * W + w) * sc + c, step p // L, lane p % L."""
    B, sc, H, W, L = 2, 4, 3, 8, 8
    t = torch.arange(B * sc * H * W, dtype=torch.int32).reshape(B, sc, H, W)
    s = rd.to_stream(t, L)
    for b, c, h, w in [(0, 0, 0, 0), (1, 3, 2, 7), (0, 2, 1, 5), (1, 1, 0, 6)]:
        p = (h * W + w) * sc + c
        assert int(s[b, p // L, p % L]) == int(t[b, c, h, w])
    np.testing.assert_array_equal(s.numpy().reshape(B, -1),
                                  t.numpy().transpose(0, 2, 3, 1).reshape(B, -1))
    back = rd.from_stream(s, sc, H, W)
    assert torch.equal(back, t) and back.is_contiguous()
    rows = rd.channel_rows(B, sc, H, W, "cpu")
    assert rd.to_stream(rows, L)[1].reshape(-1).tolist() == [p % sc for p in range(sc * H * W)]


@pytest.mark.parametrize("factorised", [False, True])
@pytest.mark.parametrize("cap", [4, 128])
def test_nchw_entry_points_round_trip_and_match_the_host_coder(request, factorised, cap):
    """encode_pack / decode_section on NCHW planes (the CPU dispatch): the
    bytes are the host coder's for the NHWC-flattened sections, and the
    decoder returns the planes as row-major NCHW int16."""
    kind = "bottleneck" if factorised else "gaussian"
    host, table, _ = request.getfixturevalue(kind)
    rng = np.random.default_rng(cap + factorised)
    B, H, W = 2, 8, 16
    n_sections, sc = (1, 8) if factorised else (3, 4)
    C = n_sections * sc
    sym = torch.from_numpy(rng.integers(-6, 7, (B, C, H, W)).astype(np.int16))
    sym[0, 1, 2, 3], sym[1, C - 1, 7, 15] = 20000, -32000
    idx = None if factorised else torch.from_numpy(
        rng.integers(0, 4, (B, C, H, W)).astype(np.uint8))
    packed, offsets, counts, esc, big = rd.encode_pack(sym, idx, n_sections, cap, table)
    L = rd.section_lanes(sc * H * W, cap)
    rows = rd.channel_rows(B, C, H, W, "cpu") if factorised else idx
    for b in range(B):
        secs = [(rd.to_stream(sym[b:b + 1, s * sc:(s + 1) * sc], L)[0].numpy(),
                 rd.to_stream(rows[b:b + 1, s * sc:(s + 1) * sc], L)[0].numpy())
                for s in range(n_sections)]
        data = tpu_encode_sections(secs, host)
        o, n = int(offsets[b]), int(counts[b])
        assert packed[o:o + n].numpy().tobytes() == data
    assert int(esc.sum()) >= 2 and int(big.sum()) == 0
    words = torch.cat([packed[int(o):int(o) + int(n)] for o, n in zip(offsets, counts)])
    base = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    cur, state = torch.zeros(B, dtype=torch.int32), None
    for s in range(n_sections):
        sec_idx = None if factorised else idx[:, s * sc:(s + 1) * sc].contiguous()
        got, cur, state = rd.decode_section(words, base, cur, state, sec_idx,
                                            (B, sc, H, W), cap, table)
        assert got.dtype == torch.int16 and got.is_contiguous()
        assert torch.equal(got, sym[:, s * sc:(s + 1) * sc])
    assert torch.equal(cur, counts)


def test_entry_points_reject_bad_input(gaussian):
    _, table, _ = gaussian
    sym = torch.zeros((1, 4, 4, 4), dtype=torch.int16)
    idx = torch.zeros((1, 4, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        rd.encode_pack(sym, idx, 1, 96, table)              # not a power of two
    with pytest.raises(ValueError):
        rd.encode_pack(sym, idx, 3, 128, table)             # 4 channels, 3 sections
    with pytest.raises(TypeError):
        rd.encode_pack(sym.to(torch.int64), idx, 1, 128, table)
    with pytest.raises(ValueError):
        rd.encode_pack(sym.to("meta"), idx.to("meta"), 1, 128, table)
    words = torch.zeros(8, dtype=torch.int16)
    zero = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        rd.decode_section(words, zero, zero, None, idx.to(torch.int32), (1, 4, 4, 4), 128, table)
    with pytest.raises(ValueError):
        rd.decode_section(words, zero, zero, None, idx, (1, 4, 4, 4), 8192, table)
    with pytest.raises(TypeError):                          # cursor of another type
        rd.decode_section(words, zero, zero.long(), None, idx, (1, 4, 4, 4), 128, table)
    with pytest.raises(TypeError):                          # one base for two images
        rd.decode_section(words, zero, zero, None, None, (2, 4, 4, 4), 128, table)
    L = rd.section_lanes(64, 128)
    for state in (torch.zeros((1, L + 1), dtype=torch.int32),      # another lane count
                  torch.zeros((1, L), dtype=torch.int64)):         # another type
        with pytest.raises(TypeError):
            rd.decode_section(words, zero, zero, state, idx, (1, 4, 4, 4), 128, table)


@pytest.mark.parametrize("L", [1 << k for k in range(13)])
def test_encode_scratch_enumerates_every_lane_once(L):
    """R1's lane groups, in entry order, visit every (step, lane) of the
    stream once and in stream order; the scratch holds a word per symbol,
    three masks per group and their prefixes with the totals."""
    for B, C, HW, S in ((1, 12, 4096, 3), (3, 192, 1536, 6), (2, 8, 512, 1)):
        if (C // S * HW) % L:
            continue
        sc = C // S
        got = rd.encode_scratch(B, C, HW, S, L)
        steps = S * (sc * HW // L)
        assert got["steps"] == steps and got["groups"] * min(L, 32) == L
        assert got["entries"] == steps * got["groups"]
        assert got["rec"] == (B, C * HW)
        assert got["masks"] == (B, 3, got["entries"])
        assert got["prefix"] == (B, 3, got["entries"] + 1)
        seen = [(e // got["groups"]) * L + (e % got["groups"]) * 32 + lane
                for e in range(got["entries"]) for lane in range(32)
                if (e % got["groups"]) * 32 + lane < L]
        assert seen == list(range(C * HW))


@pytest.mark.parametrize("kind", ["gaussian", "bottleneck", "wide"])
def test_packed_pair_table_holds_every_bin_the_lut_gives(request, kind):
    """R2's packed pair table (copied into shared memory, or read in place
    when it is wide): row r's valid bins from pair_base[r], equal to the
    full table's, zero-padded to whole 16-byte copies; every bin the LUT
    returns for row r lies among them."""
    _, table, _ = request.getfixturevalue(kind)
    packed, base = table.pair_packed.numpy(), table.pair_base.numpy()
    pair = table.pair.numpy().reshape(table.rows, table.cols)
    bins = table.maxv.numpy() + 1
    assert packed.size % 4 == 0 and packed.size - bins.sum() < 4
    assert (packed.size > 44 * 1024) == (kind == "wide")
    assert not packed[bins.sum():].any()
    lut = table.lut.numpy().view(np.uint16)
    for r in range(table.rows):
        np.testing.assert_array_equal(packed[base[r]:base[r] + bins[r]], pair[r, :bins[r]])
        assert lut[r].max() == bins[r] - 1


@pytest.mark.parametrize("cap", [4, 128, 512])
def test_wide_table_round_trips_and_matches_the_host_coder(wide, cap):
    """A factorised stream on a table wider than R2's shared-memory copy:
    encode_pack writes the host coder's bytes (escapes included) and
    decode_section returns the planes, the cursor at the stream's end."""
    host, table, _ = wide
    rng = np.random.default_rng(cap)
    B, C, H, W = 2, 192, 2, 4
    maxv = table.maxv.numpy()[None, :, None, None]
    sym = rng.integers(0, maxv, (B, C, H, W)) + table.offsets.numpy()[None, :, None, None]
    sym[0, 5, 1, 2], sym[1, C - 1, 0, 0] = 20000, -20000
    sym = torch.from_numpy(sym.astype(np.int16))
    packed, offsets, counts, esc, big = rd.encode_pack(sym, None, 1, cap, table)
    L = rd.section_lanes(C * H * W, cap)
    rows = rd.channel_rows(B, C, H, W, "cpu")
    for b in range(B):
        sec = [(rd.to_stream(sym[b:b + 1], L)[0].numpy(),
                rd.to_stream(rows[b:b + 1], L)[0].numpy())]
        o, n = int(offsets[b]), int(counts[b])
        assert packed[o:o + n].numpy().tobytes() == tpu_encode_sections(sec, host)
    assert int(esc.sum()) == 2 and int(big.sum()) == 0
    words = torch.cat([packed[int(o):int(o) + int(n)] for o, n in zip(offsets, counts)])
    base = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    got, cur, state = rd.decode_section(words, base, torch.zeros(B, dtype=torch.int32), None,
                                        None, (B, C, H, W), cap, table)
    assert torch.equal(got, sym) and torch.equal(cur, counts)
    assert bool((state == rd.RANS_L).all())


def test_rans_stamps_instruments_the_current_source():
    """tools/rans_stamps.py finds each of its anchors once in the package's
    csrc/rans_device.cu, so the measuring build follows the kernels."""
    from dc_vic_tpu_torch.tools import rans_stamps
    src = rans_stamps.instrument()
    assert src.count("= clk();") == 5 and "dcvic_read_stamps" in src
