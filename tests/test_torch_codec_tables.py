"""Integer parity of the port's entropy-coding pieces with the JAX
package's: CDF tables, CDF index derivation, the host rANS coder, the
stream header and the config loader. All must be exact: they define the
bitstream."""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("rel,port_rel", [
    ("utils/config.py", "utils/config.py"),
    ("utils/registry.py", "utils/registry.py"),
    ("codec/container.py", "codec/container.py"),
    ("codec/tiling.py", "codec/tiling.py"),
    ("ops/rans/rans.cpp", "csrc/rans.cpp")])
def test_jax_free_copies_are_byte_equal(rel, port_rel):
    """The port carries its own copies of the JAX package's jax-free
    modules and of the host rANS coder's source (it cannot import that
    package, and compiles nothing out of it); they must not drift."""
    with open(os.path.join(ROOT, "dc_vic_tpu", rel), "rb") as f:
        want = f.read()
    with open(os.path.join(ROOT, "dc_vic_tpu_torch", port_rel), "rb") as f:
        assert f.read() == want


def test_native_sources_lie_inside_the_port():
    """Every source the port compiles is its own file under csrc/."""
    from dc_vic_tpu_torch.ops import native
    pkg = os.path.join(ROOT, "dc_vic_tpu_torch", "csrc")
    for src in [native.RANS_SOURCE, *native.CUDA_SOURCES]:
        assert os.path.dirname(os.path.abspath(src)) == pkg, src
        assert os.path.isfile(src), src


def test_pmf_to_quantized_cdf_matches_jax():
    """The port's vectorized zero-bin repair against the JAX package's loop
    on PMFs with many empty and tiny bins, errors included."""
    from dc_vic_tpu.ops.cdf import pmf_to_quantized_cdf as jax_cdf
    from dc_vic_tpu_torch.ops.cdf import pmf_to_quantized_cdf
    rng = np.random.default_rng(4)
    for _ in range(60):
        n = int(rng.integers(2, 200))
        pmf = rng.exponential(1, n) ** rng.uniform(1, 40)
        pmf[rng.random(n) < rng.uniform(0, 0.9)] = 0
        pmf[rng.integers(0, n)] += 1e-3
        pmf = pmf / pmf.sum() * rng.uniform(0.5, 1)
        np.testing.assert_array_equal(pmf_to_quantized_cdf(pmf), jax_cdf(pmf))
    for bad in ([0.0, 0.0], [1.0, 0.0, 0.0, 0.0]):
        with pytest.raises(ValueError):
            jax_cdf(bad, precision=1)
        with pytest.raises(ValueError):
            pmf_to_quantized_cdf(bad, precision=1)


def test_gaussian_cdf_table_matches_jax():
    from dc_vic_tpu.codec.gaussian import GaussianConditional as JaxGC
    from dc_vic_tpu_torch.codec.gaussian import GaussianConditional
    want = JaxGC().build_cdf_table()
    got = GaussianConditional().build_cdf_table()
    for name in ("cdfs", "cdf_lengths", "offsets"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def _bottleneck_params(C=24, seed=0):
    rng = np.random.default_rng(seed)
    sizes = (1, 3, 3, 3, 3, 1)
    p = {}
    for i in range(5):
        p[f"matrix_{i}"] = rng.normal(0.3, 0.5, (C, sizes[i + 1], sizes[i]))
        p[f"bias_{i}"] = rng.uniform(-0.5, 0.5, (C, sizes[i + 1], 1))
        if i < 4:
            p[f"factor_{i}"] = rng.normal(0.0, 0.3, (C, sizes[i + 1], 1))
    med = rng.normal(0.0, 0.7, C)
    p["quantiles"] = np.stack([med - rng.uniform(2, 12, C), med,
                               med + rng.uniform(2, 12, C)], -1).reshape(C, 1, 3)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _port_bottleneck(p):
    from dc_vic_tpu_torch.codec.bottleneck import EntropyBottleneck
    m = EntropyBottleneck(p["quantiles"].shape[0])
    m.load_state_dict({("quantiles" if k == "quantiles" else
                        "_" + k.replace("_", "")): torch.from_numpy(v)
                       for k, v in p.items()})
    return m


def test_bottleneck_cdf_table_matches_jax():
    from dc_vic_tpu.codec.bottleneck import EntropyBottleneck as JaxEB
    from dc_vic_tpu.codec.bottleneck import build_bottleneck_cdf as jax_build
    from dc_vic_tpu_torch.codec.bottleneck import build_bottleneck_cdf
    p = _bottleneck_params()
    want = jax_build(JaxEB(24), {"params": p})
    got = build_bottleneck_cdf(_port_bottleneck(p))
    for name in ("cdfs", "cdf_lengths", "offsets"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_likelihoods_match_jax():
    """Gaussian and factorized likelihoods, f32, tolerance 1e-5 relative
    (erfc and sigmoid differ in their last bits between XLA and ATen)."""
    from dc_vic_tpu.codec.bottleneck import EntropyBottleneck as JaxEB
    from dc_vic_tpu.codec.gaussian import GaussianConditional as JaxGC
    from dc_vic_tpu_torch.codec.gaussian import GaussianConditional
    rng = np.random.default_rng(1)
    y = rng.normal(0, 3, (2, 8, 8, 24)).astype(np.float32)
    mu = rng.normal(0, 1, y.shape).astype(np.float32)
    sig = rng.uniform(0.01, 20, y.shape).astype(np.float32)
    want = np.asarray(JaxGC().likelihood(*map(jnp.asarray, (y, sig, mu))))
    got = GaussianConditional().likelihood(*(torch.from_numpy(a) for a in (y, sig, mu)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)

    p = _bottleneck_params()
    z_hat = np.round(rng.normal(0, 3, (2, 4, 4, 24))).astype(np.float32)
    p_jax = dict(p, quantiles=p["quantiles"] * 0)  # median 0: z_hat is its own round
    _, lik_j = JaxEB(24).apply({"params": p_jax}, jnp.asarray(z_hat), False)
    lik_t = _port_bottleneck(p).likelihood(torch.from_numpy(z_hat).permute(0, 3, 1, 2))
    np.testing.assert_allclose(lik_t.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(lik_j), rtol=1e-5, atol=1e-7)


def test_build_indexes_matches_jax_at_table_boundaries():
    """Count of table entries strictly below the scale, exact, including
    scales that are exactly table entries and values below the bound."""
    from dc_vic_tpu.codec.gaussian import GaussianConditional as JaxGC
    from dc_vic_tpu.codec.gaussian import get_scale_table as jax_table
    from dc_vic_tpu_torch.codec.gaussian import GaussianConditional, get_scale_table
    table = get_scale_table()
    np.testing.assert_array_equal(table, jax_table())
    t32 = table.astype(np.float32)
    rng = np.random.default_rng(2)
    scales = np.concatenate([
        t32, np.nextafter(t32, np.float32(0)), np.nextafter(t32, np.float32(1e9)),
        rng.uniform(0, 300, 4000).astype(np.float32),
        np.array([0.0, 0.05, 0.11, 1e6], np.float32)]).astype(np.float32)
    scales = scales.reshape(1, 1, -1, 1)
    want = np.asarray(JaxGC().build_indexes(jnp.asarray(scales), table))
    got = GaussianConditional().build_indexes(torch.from_numpy(scales), table).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_rans_host_matches_jax_coder():
    """Byte-identical streams from the JAX package's binding, decoded back
    whole and slice by slice."""
    from dc_vic_tpu.ops import rans as jax_rans
    from dc_vic_tpu_torch.codec.gaussian import GaussianConditional
    from dc_vic_tpu_torch.ops import rans_host
    table = GaussianConditional().build_cdf_table()
    jtable = jax_rans.CdfTable(table.cdfs, table.cdf_lengths, table.offsets)
    rng = np.random.default_rng(3)
    n = 6000
    idx = rng.integers(0, 64, n).astype(np.int32)
    sym = np.round(rng.normal(0, 1 + idx / 4.0)).astype(np.int32)
    sym[::997] = 4000  # escapes
    data = rans_host.encode_with_indexes(sym, idx, table)
    assert data == jax_rans.encode_with_indexes(sym, idx, jtable)
    np.testing.assert_array_equal(rans_host.decode_with_indexes(data, idx, table), sym)
    dec = rans_host.RansDecoder(data)
    parts = [dec.decode_stream(idx[a:b], table)
             for a, b in ((0, 1000), (1000, 4500), (4500, n))]
    np.testing.assert_array_equal(np.concatenate(parts), sym)


def test_header_bytes_match_jax():
    from dc_vic_tpu.codec.container import HeaderHandler as JaxHH
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    for H, W in ((768, 512), (500, 740), (96, 80), (1, 65535)):
        for q in (0, 3, 63):
            for max_abs_y in (0, 17.9, 254.5, 1e6, -3):
                got = HeaderHandler.encode((H, W), max_abs_y, q)
                assert got == JaxHH.encode((H, W), max_abs_y, q)
                assert len(got) == 6 and got[5] == q
                assert HeaderHandler.decode(got) == JaxHH.decode(got)


@pytest.mark.parametrize(
    "path", sorted(os.path.relpath(p, ROOT) for p in
                   glob.glob(os.path.join(ROOT, "config", "**", "*.yaml"),
                             recursive=True)))
def test_config_loader_matches_jax(path):
    from dc_vic_tpu.utils.config import load_config as jax_load
    from dc_vic_tpu_torch.utils.config import load_config
    full = os.path.join(ROOT, path)
    assert load_config(full).to_plain() == jax_load(full).to_plain()
