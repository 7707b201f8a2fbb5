"""The fused residual block's GroupNorm statistics (``ops/gn.py::fold_stats``,
kernel ``gn_fold`` in ``csrc/gn.cu``): the plain version against the JAX
package's ``_gn_fold``, the Function's backward against autograd of the plain
composite, the wrapper's refusals, and, on the card, the kernel against the
plain version. The JAX package is imported inside the tests that use it, so
the card's tests run where JAX is not installed: ``python -m pytest
--noconftest -p no:cacheprovider tests/test_torch_gn_fold.py -m cuda``."""
import numpy as np
import pytest
import torch

from dc_vic_tpu_torch.ops import gn

EPS = 1e-6


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _params(C, gen, device="cpu", dtype=torch.float32):
    gamma = (torch.rand(C, generator=gen) + 0.5).to(device, dtype)
    beta = torch.randn(C, generator=gen).to(device, dtype)
    return gamma, beta


def _two_pass_f64(x, G):
    """(mean, var) per (image, group) in float64: the quantity both versions
    compute."""
    xg = x.double().reshape(x.shape[0], G, -1)
    mean = xg.mean(-1)
    return mean, ((xg - mean[..., None]) ** 2).mean(-1)


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_stats_plain_matches_jax_gn_fold(dtype):
    """``fold_stats_plain`` on NCHW against the JAX package's ``_gn_fold`` on
    the same map in NHWC, in f32 and bf16. Group 3 has a mean of 1000 and a
    spread of 0.01 (in bf16: a few levels around 256): there E[x^2] - E[x]^2
    in f32 is off by more than the variance itself, so the two-pass meaning
    is pinned (in f32) against float64."""
    import jax.numpy as jnp
    from dc_vic_tpu.models.vqgan import _gn_fold
    rng = np.random.default_rng(5)
    B, H, W, C, G = 2, 6, 10, 64, 32
    x = rng.normal(0.3, 1.5, (B, H, W, C)).astype(np.float32)
    big = slice(3 * C // G, 4 * C // G)
    x[..., big] = (1000.0 + 0.01 * rng.normal(size=(B, H, W, 2))) if dtype == "float32" \
        else 256.0 + 2.0 * rng.integers(0, 3, (B, H, W, 2))
    gamma = rng.uniform(0.5, 1.5, C).astype(np.float32)
    beta = rng.normal(size=C).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = _gn_fold(jnp.asarray(x, jdt), jnp.asarray(gamma), jnp.asarray(beta), G, EPS)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    got = gn.fold_stats_plain(xt, torch.from_numpy(gamma), torch.from_numpy(beta), G, EPS)
    rest = np.r_[0:big.start, big.stop:C]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (B, C)
        # another f32 summation order; in group 3 a mean of 1000 known to a
        # few of its last places (6e-5) moves the variance of 1e-4
        np.testing.assert_allclose(g.numpy()[:, rest], np.asarray(w)[:, rest], rtol=1e-5)
        np.testing.assert_allclose(g.numpy()[:, big], np.asarray(w)[:, big], rtol=2e-4)
    mean, var = _two_pass_f64(xt, G)
    want_scale = torch.from_numpy(gamma).double() * torch.rsqrt(var + EPS).repeat_interleave(2, 1)
    np.testing.assert_allclose(got[0].numpy(), want_scale.numpy(), rtol=2e-3)
    if dtype == "float32":
        xg = xt.reshape(B, G, -1)
        fast = (xg * xg).mean(-1) - xg.mean(-1) ** 2
        assert ((fast[:, 3].double() - var[:, 3]).abs() > var[:, 3]).all()


def _fold_grads(fn, x, gamma, beta, gs, gb, need):
    leaves = [t.detach().clone().requires_grad_(n) for t, n in zip((x, gamma, beta), need)]
    scale, bias = fn(*leaves)
    want = [t for t in leaves if t.requires_grad]
    return torch.autograd.grad((scale * gs).sum() + (bias * gb).sum(), want)


@pytest.mark.parametrize("need", [(True, False, False), (True, True, True),
                                  (False, True, True)], ids=["x", "x_gamma_beta",
                                                             "gamma_beta"])
def test_fold_stats_function_gradcheck(need):
    """``_FoldStats`` in float64: its closed-form backward against finite
    differences, and against autograd of the plain composite, with x alone,
    with gamma and beta too, and with gamma and beta alone."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 8, 3, 5, generator=gen, dtype=torch.float64) * 1.3 + 0.4
    gamma, beta = _params(8, gen, dtype=torch.float64)
    inputs = [t.clone().requires_grad_(n) for t, n in zip((x, gamma, beta), need)]
    assert torch.autograd.gradcheck(lambda *a: gn._FoldStats.apply(*a, 4, EPS), inputs)
    gs, gb = torch.randn(2, 2, 8, generator=gen, dtype=torch.float64)
    got = _fold_grads(lambda *a: gn._FoldStats.apply(*a, 4, EPS), x, gamma, beta, gs, gb, need)
    want = _fold_grads(lambda *a: gn.fold_stats_plain(*a, 4, EPS), x, gamma, beta, gs, gb,
                       need)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_stats_backward_in_the_working_types(dtype):
    """The Function's gradients on f32 and bf16 maps (the training cell's
    and the codec's types) against autograd of the plain composite, in the
    types of x, gamma and beta."""
    gen = torch.Generator().manual_seed(8)
    x = (torch.randn(3, 64, 9, 7, generator=gen) * 2 + 0.5).to(dtype)
    gamma, beta = _params(64, gen)
    gs, gb = torch.randn(2, 3, 64, generator=gen)
    need = (True, True, True)
    got = _fold_grads(lambda *a: gn.fold_stats(*a, 32, EPS), x, gamma, beta, gs, gb, need)
    want = _fold_grads(lambda *a: gn.fold_stats_plain(*a, 32, EPS), x, gamma, beta, gs, gb,
                       need)
    for g, w, t in zip(got, want, (x, gamma, beta)):
        assert g.dtype == t.dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["float16", "int32", "groups", "three_d", "gamma", "beta"])
def test_fold_stats_refuses(case):
    """The wrapper refuses a type it does not take, channels that the groups
    do not divide, a map that is not 4-D and parameters of another length."""
    x = torch.randn(2, 8, 4, 4)
    gamma, beta = torch.ones(8), torch.zeros(8)
    groups = 4
    if case in ("float16", "int32"):
        x, err = x.to(getattr(torch, case)), TypeError
    elif case == "groups":
        groups, err = 3, ValueError
    elif case == "three_d":
        x, err = x[0], ValueError
    elif case == "gamma":
        gamma, err = torch.ones(4), ValueError
    else:
        beta, err = torch.zeros(9), ValueError
    with pytest.raises(err):
        gn.fold_stats(x, gamma, beta, groups)


def test_fused_block_statistics_take_fold_stats():
    """``gn_fold`` of the fused residual block is ``fold_stats``: the same
    bits as the plain version on the CPU, through the Function."""
    from dc_vic_tpu_torch.models.vqgan import gn_fold
    from dc_vic_tpu_torch.nn.layers import GroupNorm
    gen = torch.Generator().manual_seed(9)
    norm = GroupNorm(32, 128)
    with torch.no_grad():
        norm.weight.copy_(torch.rand(128, generator=gen) + 0.5)
        norm.bias.copy_(torch.randn(128, generator=gen))
    x = torch.randn(2, 128, 6, 8, generator=gen).requires_grad_(True)
    scale, bias = gn_fold(x, norm)
    assert type(scale.grad_fn).__name__ == "_FoldStatsBackward"
    for g, w in zip((scale, bias), gn.fold_stats_plain(x, norm.weight, norm.bias, 32, norm.eps)):
        assert torch.equal(g, w)


# ----------------------------------------------------------------- card

# (shape, groups, x dtype, gamma and beta dtype): one chunk; several; n no
# multiple of the chunk; n odd (scalar loads); bf16 parameters
CARD_CASES = [((2, 128, 96, 64), 32, torch.float32, torch.float32),
              ((2, 256, 128, 192), 32, torch.bfloat16, torch.float32),
              ((2, 256, 128, 192), 32, torch.float32, torch.float32),
              ((2, 64, 150, 130), 32, torch.float32, torch.float32),
              ((1, 96, 257, 255), 32, torch.bfloat16, torch.float32),
              ((1, 96, 257, 255), 32, torch.float32, torch.float32),
              ((3, 128, 64, 96), 32, torch.bfloat16, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,G,dtype,pdtype", CARD_CASES)
def test_gn_fold_kernel_matches_plain(dev, shape, G, dtype, pdtype):
    """The kernel against the plain version on the same input: both hold the
    float64 two-pass statistics, and each other within 2e-6 of the scale's
    and the bias's size (f32 sums in another order)."""
    g = torch.Generator(device=dev).manual_seed(shape[2])
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    gamma, beta = _params(shape[1], torch.Generator().manual_seed(1), dev, pdtype)
    before = gn.launches["gn_fold"]
    got = gn.fold_stats(x, gamma, beta, G, EPS)
    assert gn.launches["gn_fold"] == before + 1
    want = gn.fold_stats_plain(x, gamma, beta, G, EPS)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == shape[:2] and a.is_contiguous()
        torch.testing.assert_close(a, b, rtol=2e-6, atol=2e-6 * float(b.abs().max()))
    mean, var = _two_pass_f64(x, G)
    rep = lambda t: t.repeat_interleave(shape[1] // G, 1)
    scale = gamma.double() * rep(torch.rsqrt(var + EPS))
    torch.testing.assert_close(got[0].double(), scale, rtol=2e-6, atol=0)
    torch.testing.assert_close(got[1].double(), beta.double() - rep(mean) * scale, rtol=0,
                               atol=2e-6 * float(scale.abs().max() * x.abs().max()))


@pytest.mark.cuda
def test_gn_fold_kernel_two_pass_at_a_large_mean(dev):
    """A group of mean 1000 and spread 0.01 in f32, over several chunks:
    the kernel's variance within 1e-3 of float64's, where E[x^2] - E[x]^2
    in f32 misses by more than the variance."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(2, 64, 256, 192, generator=g, device=dev)
    x[:, 4:6] = 1000.0 + 0.01 * x[:, 4:6]
    gamma, beta = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    scale, _ = gn.fold_stats(x, gamma, beta, 32, 0.0)
    _, var = _two_pass_f64(x, 32)
    torch.testing.assert_close(scale[:, 4].double() ** -2, var[:, 2], rtol=1e-3, atol=0)
    xg = x.reshape(2, 32, -1)[:, 2]
    fast = (xg * xg).mean(-1) - xg.mean(-1) ** 2
    assert ((fast.double() - var[:, 2]).abs() > var[:, 2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gn_fold_kernel_is_bit_identical_across_calls_and_batches(dev, dtype):
    """Two calls give the same bits, and image k of a batch of 16 the bits
    of that image alone (several chunks a group)."""
    g = torch.Generator(device=dev).manual_seed(16)
    x = (torch.randn(16, 128, 192, 256, generator=g, device=dev) * 3 - 1).to(dtype)
    gamma, beta = _params(128, torch.Generator().manual_seed(2), dev)
    first = gn.fold_stats(x, gamma, beta, 32, EPS)
    again = gn.fold_stats(x, gamma, beta, 32, EPS)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    for k in (0, 5, 15):
        alone = gn.fold_stats(x[k:k + 1].clone(), gamma, beta, 32, EPS)
        assert all(torch.equal(a[k:k + 1], b) for a, b in zip(first, alone))


@pytest.mark.cuda
def test_gn_fold_kernel_on_two_streams_at_once(dev):
    """Launches on two streams of one device that overlap each count their
    own groups' tickets: every output has the bits of the same call made
    alone on the default stream."""
    g = torch.Generator(device=dev).manual_seed(17)
    xs = [(torch.randn(8, 128, 192, 256, generator=g, device=dev) + k).to(torch.bfloat16)
          for k in range(2)]
    gamma, beta = _params(128, torch.Generator().manual_seed(5), dev)
    want = [gn.fold_stats(x, gamma, beta, 32, EPS) for x in xs]
    streams = [torch.cuda.Stream(dev) for _ in xs]
    torch.cuda.synchronize(dev)
    got = [[], []]
    for _ in range(20):
        for k, (s, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(s):
                got[k].append(gn.fold_stats(x, gamma, beta, 32, EPS))
    torch.cuda.synchronize(dev)
    for k in range(2):
        for out in got[k]:
            assert all(torch.equal(a, b) for a, b in zip(out, want[k]))


@pytest.mark.cuda
def test_fused_block_launches_gn_fold_twice(dev):
    """A fused residual block's forward on the card launches ``gn_fold`` once
    for each of its two GroupNorms, and nothing of the plain version."""
    from dc_vic_tpu_torch.models.vqgan import VQResnetBlock
    blk = VQResnetBlock(128, 128).to(dev)
    blk.fused = True
    x = torch.randn(2, 128, 96, 128, device=dev)
    assert blk.takes_fused(x.shape)
    before = gn.launches["gn_fold"]
    with torch.no_grad():
        blk(x)
    assert gn.launches["gn_fold"] == before + 2


@pytest.mark.cuda
def test_gn_fold_training_backward_matches_plain(dev):
    """At a training plane (f32, batch 6 of 256x256, 128 channels) the
    Function's gradients of x, gamma and beta against autograd of the plain
    composite on the same upstream gradients; one backward counted."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(6, 128, 256, 256, generator=g, device=dev) * 1.5 + 0.2
    gamma, beta = _params(128, torch.Generator().manual_seed(3), dev)
    gs, gb = torch.randn(2, 6, 128, generator=g, device=dev)
    need = (True, True, True)
    before = gn.backwards["gn_fold"]
    got = _fold_grads(lambda *a: gn.fold_stats(*a, 32, EPS), x, gamma, beta, gs, gb, need)
    assert gn.backwards["gn_fold"] == before + 1
    want = _fold_grads(lambda *a: gn.fold_stats_plain(*a, 32, EPS), x, gamma, beta, gs, gb,
                       need)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
