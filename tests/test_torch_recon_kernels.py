"""The reconstruction kernels' plain versions, their routing and their shape
rules against the JAX package (ops/gn.py, ops/conv3x3.py, the fused
VQResnetBlock), on the CPU.

Inputs come from ``numpy.random.default_rng(seed)`` and are transposed
NHWC <-> NCHW and HWIO <-> OIHW here. Where the JAX function reaches a Pallas
kernel it runs in interpret mode, as tests/test_gn.py and
tests/test_conv3x3.py run it. On the CPU the port's wrappers take their plain
versions, so these tests hold the arithmetic and the routing; the CUDA
kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py). Each tolerance is stated in its test.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from helpers import tiny_config
from test_torch_layers import DD, _init, _load, _nchw, _x

from dc_vic_tpu_torch.ops import conv3x3, gn

ALL_KERNELS = ("gn", "conv3x3", "fused_resblock")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.fixture()
def any_shape(monkeypatch):
    """Let every shape pass the kernels' shape rules, so that the kernel
    routes run at sizes a CPU test can afford."""
    monkeypatch.setattr(gn, "use_kernel", lambda shape: len(shape) == 4)
    monkeypatch.setattr(conv3x3, "use_kernel", lambda *a: True)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


# ------------------------------------------------------------- K3 and K4

def test_channel_sums_plain_matches_pallas_kernel_and_xla():
    """rtol 1e-5, atol 1e-3 (sums of 2048 values; the tolerance the JAX
    package holds its kernel to)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from dc_vic_tpu.ops import gn as jgn
    B, H, W, C = 2, 64, 32, 128
    x = np.random.default_rng(2).standard_normal((B, H, W, C)).astype(np.float32)
    T = jgn._h_tile(H, W, C, 4)
    kernel = pl.pallas_call(
        jgn._gn_stats_kernel, grid=(B, H // T),
        in_specs=[pl.BlockSpec((1, T, W, C), lambda b, t: (b, t, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 8, C), lambda b, t: (b, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((B, 8, C), jnp.float32),
        interpret=True)(jnp.asarray(x))[:, :2, :]
    got = gn.channel_sums(_nchw(x))
    assert got.shape == (B, 2, C) and got.dtype == torch.float32
    assert torch.equal(got, gn.channel_sums_plain(_nchw(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgn.channel_sums(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-3)


def test_channel_sums_plain_against_float64():
    """The cancellation-prone statistics: within 1e-5 of sum|x| and sum x^2
    of a float64 sum, on a plane of the flagship's largest size."""
    x = (np.random.default_rng(3).standard_normal((1, 2, 768, 512)) * 2 + 3).astype(np.float32)
    got = gn.channel_sums_plain(torch.from_numpy(x)).double().numpy()
    xd = x.astype(np.float64).reshape(1, 2, -1)
    want = np.stack([xd.sum(-1), (xd * xd).sum(-1)], 1)
    scale = np.stack([np.abs(xd).sum(-1), (xd * xd).sum(-1)], 1)
    assert np.all(np.abs(got - want) <= 1e-5 * scale)


@pytest.mark.parametrize("act", [None, "swish"])
@pytest.mark.parametrize("shape,groups", [((2, 24, 16, 64), 32), ((1, 5, 7, 12), 4)])
def test_group_norm_matches_jax(shape, groups, act):
    """atol = rtol = 2e-5, the JAX package's own tolerance against flax."""
    from dc_vic_tpu.ops import gn as jgn
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    gamma = (rng.standard_normal(shape[-1]) * 0.2 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    want = jgn.group_norm(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                          groups, act=act)
    got = gn.group_norm(_nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                        groups, act=act)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_gn_stats_match_jax():
    """(mean, var) per group; rtol 1e-5, atol 1e-6 as tests/test_gn.py."""
    from dc_vic_tpu.ops import gn as jgn
    x = (np.random.default_rng(3).standard_normal((2, 16, 8, 64)) * 1.5).astype(np.float32)
    for got, want in zip(gn.gn_stats(_nchw(x), 32), jgn.gn_stats(jnp.asarray(x), 32)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_group_norm_module_routes_by_flag_and_shape():
    """Flag off, or a shape outside the rule: the ordinary forward, bit for
    bit. Flag on and a shape inside the rule: ops.gn.group_norm."""
    from dc_vic_tpu_torch.nn.layers import GroupNorm
    rng = np.random.default_rng(4)
    norm = GroupNorm(32, 128, act="swish")
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(rng.standard_normal(128).astype(np.float32)))
    small = torch.from_numpy(rng.standard_normal((1, 128, 8, 8)).astype(np.float32))
    big = torch.from_numpy(rng.standard_normal((1, 128, 64, 32)).astype(np.float32))
    with torch.no_grad():
        off_small, off_big = norm(small), norm(big)
        norm.recon_kernel = True
        assert not norm.takes_kernel(small.shape) and norm.takes_kernel(big.shape)
        assert torch.equal(norm(small), off_small)
        on_big = norm(big)
    want = gn.group_norm(big, norm.weight, norm.bias, 32, norm.eps, "swish")
    assert torch.equal(on_big, want)
    torch.testing.assert_close(on_big, off_big, atol=2e-5, rtol=2e-5)


# ------------------------------------------------------------- K5 and K6

# bf16 against the Pallas kernel: one step of the output type (atol = rtol =
# 1e-2) where the two f32 sums round to neighbouring bf16 values, and under
# 0.5% of the outputs differing at all (two roundings of the sum differ in
# about 28%)
_BF16_TOL = dict(atol=1e-2, rtol=1e-2)
_BF16_DIFFERING = 0.005


def _as(a, dtype):
    """numpy f32 -> (the array in ``dtype``, as JAX takes it, as the port
    takes it): bf16 values cast once, the same bits in both packages."""
    if a is None:
        return None, None
    if dtype == "float32":
        return jnp.asarray(a), torch.from_numpy(a)
    t = torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a).astype(jnp.bfloat16), t


def _held_to_pallas(got, want, dtype, frame=None):
    """``got`` (NHWC numpy f32) against the Pallas kernel's ``want``: f32
    1e-4 (XLA's interpreter and oneDNN sum in other orders); bf16 as above.
    ``frame`` also compares the one-pixel border on its own."""
    want = np.asarray(want.astype(jnp.float32))
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else _BF16_TOL
    if frame is not None:
        np.testing.assert_allclose(got[:, frame], want[:, frame], **tol)
    np.testing.assert_allclose(got, want, **tol)
    if dtype == "bfloat16":
        differing = float(np.mean(got != want))
        assert differing < _BF16_DIFFERING, f"{differing:.2%} of the outputs differ"


@pytest.mark.parametrize("shape,dtype", [
    ((1, 8, 24, 256, 128), "float32"), ((2, 12, 16, 128, 256), "float32"),
    ((1, 8, 24, 256, 128), "bfloat16"), ((2, 12, 16, 128, 256), "bfloat16")],
    ids=["shape0", "shape1", "bf16-shape0", "bf16-shape1"])
def test_conv3x3_plain_matches_pallas_kernel(interpret_pallas, shape, dtype):
    """f32: atol = rtol = 1e-4; bf16: inputs cast to bf16 in both packages,
    one bf16 step and under 0.5% of the outputs differing."""
    from dc_vic_tpu.ops.conv3x3 import conv3x3_same
    B, H, W, C, Cout = shape
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Cout)) * 0.05).astype(np.float32)
    (jx, tx), (jw, tw) = _as(x, dtype), _as(w, dtype)
    want = conv3x3_same(jx, jw)
    tx, tw = tx.permute(0, 3, 1, 2), tw.permute(3, 2, 0, 1)
    got = conv3x3.conv3x3_same(tx, tw)
    assert got.dtype == getattr(torch, dtype)
    assert torch.equal(got, conv3x3.conv3x3_same_plain(tx, tw))
    _held_to_pallas(_nhwc(got.float()), want, dtype)


@pytest.mark.parametrize("with_res,dtype", [
    (False, "float32"), (True, "float32"), (False, "bfloat16"), (True, "bfloat16")],
    ids=["False", "True", "bf16-False", "bf16-True"])
def test_conv3x3_gn_swish_plain_matches_pallas_kernel(interpret_pallas, with_res, dtype):
    """f32: atol = rtol = 1e-4; bf16: one bf16 step and under 0.5% of the
    outputs differing, which holds the plain version to one rounding of the
    f32 sum of conv, conv bias and residual, as the Pallas kernel rounds.
    The affine's bias is near 2: a halo that went through affine and swish
    instead of being zero would add about 1.8 per border tap, so the border
    is also compared on its own."""
    from dc_vic_tpu.ops.conv3x3 import conv3x3_gn_swish
    rng = np.random.default_rng(2)
    B, H, W, C, Cout = 2, 8, 24, 128, 128
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rng.standard_normal((3, 3, C, Cout)) * 0.05).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (B, C)).astype(np.float32)
    bias = (rng.standard_normal((B, C)) + 2.0).astype(np.float32)
    cbias = rng.standard_normal((Cout,)).astype(np.float32)
    res = rng.standard_normal((B, H, W, Cout)).astype(np.float32) if with_res else None
    (jx, tx), (jw, tw), (jr, tr) = _as(x, dtype), _as(w, dtype), _as(res, dtype)
    want = conv3x3_gn_swish(jx, jw, jnp.asarray(scale), jnp.asarray(bias),
                            jnp.asarray(cbias), jr)
    got = conv3x3.conv3x3_gn_swish(
        tx.permute(0, 3, 1, 2), tw.permute(3, 2, 0, 1), torch.from_numpy(scale),
        torch.from_numpy(bias), torch.from_numpy(cbias),
        None if tr is None else tr.permute(0, 3, 1, 2))
    assert got.dtype == getattr(torch, dtype)
    frame = np.ones((H, W), bool)
    frame[1:-1, 1:-1] = False
    _held_to_pallas(_nhwc(got.float()), want, dtype, frame)


def test_conv2d_module_routes_by_flag_and_shape(any_shape):
    """Only a 3x3 stride-1 conv with the flag on takes the K5 route, with
    the bias added after; the entropy-parameter convs are plain nn.Conv2d."""
    from dc_vic_tpu_torch.nn.layers import Conv2d, conv
    x = torch.from_numpy(_x((1, 16, 10, 12)))
    c3, c5, c3s2 = conv(16, 8, 3), conv(16, 8, 5), conv(16, 8, 3, 2)
    for m in (c3, c5, c3s2):
        assert isinstance(m, Conv2d) and not m.takes_kernel(x.shape)
        m.recon_kernel = True
    assert c3.takes_kernel(x.shape)
    assert not c5.takes_kernel(x.shape) and not c3s2.takes_kernel(x.shape)
    with torch.no_grad():
        got = c3(x)
        want = conv3x3.conv3x3_same(x, c3.weight) + c3.bias[None, :, None, None]
        ordinary = nn.Conv2d.forward(c3, x)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, ordinary, atol=1e-5, rtol=1e-5)
    assert type(conv(16, 8, 3, entropy=True)) is nn.Conv2d


@pytest.mark.parametrize("out_ch", [128, 256])
def test_fused_resblock_matches_jax_fused_block(interpret_pallas, any_shape,
                                                monkeypatch, out_ch):
    """The port's VQResnetBlock on its fused route against the JAX block on
    its fused route (Pallas kernel in interpret mode), same parameters
    through the export mapping; atol = rtol = 2e-4, the tolerance the JAX
    package holds fused to unfused. out_ch 256 takes the 1x1 shortcut."""
    from dc_vic_tpu.models import vqgan as J
    from dc_vic_tpu_torch.models.vqgan import VQResnetBlock
    x = _x((1, 8, 24, 128), seed=4, scale=0.7)
    jm = J.VQResnetBlock(out_ch=out_ch)
    p = _init(jm, jnp.asarray(x))
    tm = _load(VQResnetBlock(128, out_ch), p, ("vq_model", "encoder", "down_1_block_0"),
               "vq_model.encoder.down.1.block.0.")
    with torch.no_grad():
        unfused = tm(_nchw(x))
        tm.fused = True
        assert tm.takes_fused((1, 128, 8, 24))
        got = tm(_nchw(x))
    monkeypatch.setattr(J, "_use_fused_resblock", lambda *a: True)
    want = jm.apply({"params": p}, jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_nhwc(got), _nhwc(unfused), atol=2e-4, rtol=2e-4)


# ------------------------------------------------------ the slice as a whole

def _set_all(module):
    from dc_vic_tpu_torch.models import set_recon_kernels
    set_recon_kernels(module, ALL_KERNELS)


def test_vq_encoder_with_kernels_on_matches_jax(any_shape):
    """The VQGAN encoder with all three routes taken at every layer against
    the JAX encoder; atol = rtol = 1e-4 as tests/test_torch_layers.py holds
    the same module on its ordinary route."""
    from dc_vic_tpu.models.vqgan import VQEncoder as J
    from dc_vic_tpu_torch.models.vqgan import VQEncoder
    x = _x((2, 32, 24, 3))
    jm = J(**DD)
    p = _init(jm, jnp.asarray(x))
    tm = _load(VQEncoder(**DD), p, ("vq_model", "encoder"), "vq_model.encoder.")
    _set_all(tm)
    before = dict(gn.launches), dict(conv3x3.launches)
    with torch.no_grad():
        got = tm(_nchw(x))
    assert (gn.launches, conv3x3.launches) == before    # CPU: plain versions
    np.testing.assert_allclose(_nhwc(got), np.asarray(jm.apply({"params": p}, jnp.asarray(x))),
                               atol=1e-4, rtol=1e-4)


def test_vq_decoder_with_sft_taps_and_kernels_on_matches_jax(any_shape):
    """The fused decoder (VQGAN decoder plus SFT blocks) with all three
    routes taken; atol = rtol = 1e-4 as for the ordinary route."""
    from dc_vic_tpu.models.vqgan import VQDecoder as J
    from dc_vic_tpu_torch.models.dc_vic import FusionModule
    from dc_vic_tpu_torch.models.vqgan import VQDecoder
    z = _x((2, 8, 6, 4))
    cond = {"block_1_2": _x((2, 8, 6, 16), seed=2),
            "block_1_1": _x((2, 16, 12, 16), seed=3)}
    jm = J(**DD, fuse_schedule={"block_1_2": {"mid_ch": 32}, "block_1_1": {"mid_ch": 16}})
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    p = _init(jm, jnp.asarray(z), jcond, 0.8)
    holder = nn.Module()
    holder.vq_model = nn.Module()
    holder.vq_model.decoder = VQDecoder(**DD)
    holder.fusion_module = FusionModule({
        "block_1_2": dict(dec_ch=64, cond_ch=16, mid_ch=32),
        "block_1_1": dict(dec_ch=32, cond_ch=16, mid_ch=16)})
    _load(holder, p, ("fused_decoder",), "")
    tcond = {k: _nchw(v) for k, v in cond.items()}
    with torch.no_grad():
        off = holder.vq_model.decoder(_nchw(z), holder.fusion_module.fusion_modules, tcond, 0.8)
        _set_all(holder)
        on = holder.vq_model.decoder(_nchw(z), holder.fusion_module.fusion_modules, tcond, 0.8)
    assert not torch.equal(on, off)          # the routes were really taken
    np.testing.assert_allclose(_nhwc(on), np.asarray(jm.apply({"params": p}, jnp.asarray(z),
                                                              jcond, 0.8)),
                               atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def tiny_models():
    from dc_vic_tpu_torch.models import build_comp_model, init_weights
    off = build_comp_model(tiny_config(), device="cpu")
    on = build_comp_model(tiny_config(), device="cpu", recon_kernels=ALL_KERNELS)
    init_weights(off.module, torch.Generator().manual_seed(0))
    on.module.load_state_dict(off.module.state_dict(), strict=True)
    return off.module.eval(), on.module.eval()


def test_recon_kernels_add_no_parameter(tiny_models):
    """Options on or off: the same state_dict keys and shapes, so the
    reference loader needs no change."""
    off, on = tiny_models
    a, b = off.state_dict(), on.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)


def test_recon_kernels_are_stored_on_the_modules_they_concern(tiny_models):
    from dc_vic_tpu_torch.models.vqgan import VQResnetBlock
    from dc_vic_tpu_torch.nn.layers import Conv2d, GroupNorm
    off, on = tiny_models
    seen = {GroupNorm: 0, Conv2d: 0, VQResnetBlock: 0}
    for m_off, m_on in zip(off.modules(), on.modules()):
        for cls, flag in ((GroupNorm, "recon_kernel"), (Conv2d, "recon_kernel"),
                          (VQResnetBlock, "fused")):
            if isinstance(m_on, cls):
                assert getattr(m_on, flag) is True and getattr(m_off, flag) is False
                seen[cls] += 1
    assert all(seen.values())
    # nothing that decides rANS indexes can take a reconstruction kernel
    for chain in (on.hyperdecoder, on.context_model):
        assert not any(isinstance(m, (Conv2d, GroupNorm, VQResnetBlock))
                       for m in chain.modules())


def test_recon_kernels_argument_is_checked():
    from dc_vic_tpu_torch.models import build_comp_model
    with pytest.raises(ValueError):
        build_comp_model(tiny_config(), device="cpu", recon_kernels={"gn", "conv5x5"})


def test_build_comp_model_defaults_to_the_card():
    """No device argument means the GPU; without one it raises instead of
    carrying on on the CPU."""
    from dc_vic_tpu_torch.models import build_comp_model
    if torch.cuda.is_available():
        assert next(build_comp_model(tiny_config()).module.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_comp_model(tiny_config())


def test_tiny_model_shapes_stay_on_the_ordinary_route(tiny_models):
    """The shape rules hold at build-independent call time: at the tiny
    model's widths no shape qualifies, and the reconstruction with the
    options on equals the default one bit for bit."""
    off, on = tiny_models
    y_hat = torch.from_numpy(_x((1, 24, 4, 4), seed=7))
    b1, b2 = torch.tensor([2.29]), torch.tensor([3.0])
    with torch.no_grad():
        assert torch.equal(on.reconstruct_uint8(y_hat, b1, b2),
                           off.reconstruct_uint8(y_hat, b1, b2))


def test_tiny_model_reconstruction_with_every_route_taken(tiny_models, any_shape):
    """decode_from_y_hat with every GroupNorm, 3x3 conv and VQResnetBlock of
    the pixel stacks on its kernel route against the default model on the
    same weights: atol = rtol = 1e-3 on the image and the logits, the
    tolerance tests/test_torch_model.py holds these stacks to."""
    off, on = tiny_models
    y_hat = torch.from_numpy(_x((2, 24, 4, 4), seed=8))
    b1, b2 = torch.tensor([2.29]), torch.tensor([3.0])
    with torch.no_grad():
        fake_on, _, logits_on, idx_on = on.decode_from_y_hat(y_hat, b1, b2)
        fake_off, _, logits_off, idx_off = off.decode_from_y_hat(y_hat, b1, b2)
    torch.testing.assert_close(logits_on, logits_off, atol=1e-3, rtol=1e-3)
    assert torch.equal(idx_on, idx_off)
    torch.testing.assert_close(fake_on, fake_off, atol=1e-3, rtol=1e-3)
    assert not torch.equal(fake_on, fake_off)


# ------------------------------------------------------------ shape rules

FLAGSHIP_PLANES = [  # (C, H, W) of the flagship's pixel stacks at 768x512 ...
    (128, 768, 512), (256, 768, 512), (256, 384, 256), (128, 384, 256),
    (512, 192, 128), (256, 192, 128), (512, 96, 64), (256, 96, 64), (128, 96, 64),
    (448, 192, 128), (704, 96, 64), (192, 96, 64), (3, 768, 512), (4, 96, 64),
    # ... and at 96x64
    (128, 96, 64), (256, 48, 32), (256, 24, 16), (512, 12, 8), (128, 12, 8),
    # edges of the rules
    (128, 64, 32), (128, 63, 32), (128, 96, 128), (128, 97, 128), (128, 128, 95),
    (64, 768, 512), (384, 128, 96)]


@pytest.fixture()
def jax_gates_open(monkeypatch):
    """The JAX package's gates as they stand on a TPU with the three
    opt-ins set: only their shape rules are left."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setenv("DCVIC_GN", "pallas")
    monkeypatch.setenv("DCVIC_PALLAS_CONV", "1")
    monkeypatch.setenv("DCVIC_FUSED_RESBLOCK", "1")


@pytest.mark.parametrize("batch", [1, 4])
def test_shape_rules_match_jax(jax_gates_open, batch):
    """ops.gn.use_kernel, ops.conv3x3.use_kernel and the fused block's rule
    against the JAX package's on every plane of the flagship. The JAX
    GroupNorm rule also caps a row at 2 MiB of TPU tile memory; no plane
    here reaches the cap, which the port leaves out."""
    from dc_vic_tpu.models.vqgan import _use_fused_resblock
    from dc_vic_tpu.nn.layers import _use_pallas_conv3
    from dc_vic_tpu.ops.gn import _BLOCK_BYTES, _use_pallas
    for C, H, W in FLAGSHIP_PLANES:
        assert W * C * 4 <= _BLOCK_BYTES
        assert gn.use_kernel((batch, C, H, W)) == _use_pallas(H, W, C, 4), (C, H, W)
        x = jax.ShapeDtypeStruct((batch, H, W, C), jnp.float32)
        for Cout in (128, 256, 192, 3):
            want = _use_pallas_conv3(x, Cout)
            assert conv3x3.use_kernel(batch, C, Cout, H, W) == want, (C, Cout, H, W)
            assert _use_fused_resblock(x, Cout) == want, (C, Cout, H, W)
    assert not gn.use_kernel((batch, 128, 4096))          # 4-D maps only


def test_wrappers_dispatch_by_device_without_cuda():
    """A CPU tensor takes the plain version without building anything or
    counting a launch; any other device raises instead of falling back."""
    from dc_vic_tpu_torch.ops import native
    built = "libdcvic_kernels.so" in native._libs
    x = torch.from_numpy(_x((1, 8, 6, 6)))
    w = torch.from_numpy(_x((64, 8, 3, 3), seed=2))
    sb = torch.ones(1, 8)
    cb = torch.zeros(64)
    before = dict(gn.launches), dict(conv3x3.launches)
    assert torch.equal(gn.channel_sums(x), gn.channel_sums_plain(x))
    assert torch.equal(gn.apply_affine(x, sb, sb, "swish"),
                       gn.apply_affine_plain(x, sb, sb, "swish"))
    assert torch.equal(conv3x3.conv3x3_same(x, w), conv3x3.conv3x3_same_plain(x, w))
    assert torch.equal(conv3x3.conv3x3_gn_swish(x, w, sb, sb, cb),
                       conv3x3.conv3x3_gn_swish_plain(x, w, sb, sb, cb))
    assert (gn.launches, conv3x3.launches) == before
    m = lambda t: t.to("meta")
    with pytest.raises(ValueError):
        gn.channel_sums(m(x))
    with pytest.raises(ValueError):
        gn.apply_affine(m(x), m(sb), m(sb))
    with pytest.raises(ValueError):
        conv3x3.conv3x3_same(m(x), m(w))
    with pytest.raises(ValueError):
        conv3x3.conv3x3_gn_swish(m(x), m(w), m(sb), m(sb), m(cb))
    with pytest.raises(ValueError):
        gn.apply_affine(x, sb, sb, act="relu")
    assert ("libdcvic_kernels.so" in native._libs) == built
