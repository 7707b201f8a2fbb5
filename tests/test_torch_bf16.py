"""The port's deployment numerics (``codec_dtype: bfloat16``,
``entropy_precision: default``) against the JAX package built the same way,
on the CPU.

Per module that holds a kernel and per stack, the same f32 parameters (made
from a seed, carried through the JAX package's export mapping and the
port's strict ``load_reference_state_dict``) and the same seeded inputs go
through the flax module built with ``dtype=jnp.bfloat16`` and through the
port's module with its conv and dense weights rounded to bf16.

Tolerances. bf16 keeps 8 bits, one step is 2^-8 = 3.9e-3 of a value; XLA:CPU
and oneDNN round intermediate sums at different places, so the two bf16
results differ by a few steps of the output's scale. ``_close`` holds the
largest difference under ``tol`` times the largest |value| of the f32
result: BF16_TOL = 4e-2 between the two bf16 results (the largest found was
2.5e-2, in the VQGAN decoder with SFT taps and the kernel routes on) and
F32_GAP = 4e-2 between a bf16 result and the f32 result of the same package
(largest found 2.1e-2, a fusion feature of the ELIC decoder).
A cast in the wrong place (GroupNorm statistics in bf16, attention operands
in bf16, a stack left in f32) shows above these or, for a stack left in
f32, as a bf16-to-f32 gap of exactly 0, which is refused too; the dtype of
every result is asserted as well. The entropy
chain has no tolerance against the f32 port: it must be bitwise equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torch_threads  # noqa: F401
from helpers import tiny_config
from train_helpers import flax_template
from test_torch_layers import DD, _init, _load, _nchw, _x
from test_torch_recon_kernels import any_shape, interpret_pallas  # noqa: F401 (fixtures)

from dc_vic_tpu_torch.models import set_compute_dtype

BF16_TOL = 4e-2
F32_GAP = 4e-2
BETAS = (2.29, 3.0)
BF16_CFG = dict(codec_dtype="bfloat16", entropy_precision="default")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(t, nchw=True):
    if isinstance(t, torch.Tensor):
        t = t.detach().float()
        if nchw and t.dim() == 4:
            t = t.permute(0, 2, 3, 1)
        return t.numpy()
    return np.asarray(t, dtype=np.float32)


def _close(got, want, scale_of, tol, what):
    scale = float(np.abs(scale_of).max())
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all() and err <= tol * scale, \
        f"{what}: max abs diff {err:.3e} over {tol:g} x scale {scale:.3e}"
    return err / scale


def _four_way(got16, want16, got32, want32=None, nchw=True, what=""):
    """port bf16 ~ JAX bf16; each ~ its own f32 result, and not equal to it.
    Without a JAX f32 result (the whole-model stacks, where
    tests/test_torch_model.py holds the port's f32 to the JAX f32 within
    1e-3) the port's f32 result stands in for it."""
    want32 = got32 if want32 is None else want32
    g16, w16, g32, w32 = (_np(t, nchw) for t in (got16, want16, got32, want32))
    _close(g16, w16, w32, BF16_TOL, f"{what} port bf16 vs JAX bf16")
    _close(g16, g32, g32, F32_GAP, f"{what} port bf16 vs port f32")
    _close(w16, w32, w32, F32_GAP, f"{what} JAX bf16 vs JAX f32")
    assert not np.array_equal(g16, g32), f"{what}: the port's bf16 result is its f32 result"


def _module_four_way(make_jax, torch_module, root, strip, *inputs, nchw=True, seed=0,
                     bf16_inputs=False):
    """Run one module pair in f32 and in bf16 on the same parameters;
    ``bf16_inputs`` rounds the bf16 runs' inputs too, for a module that sits
    behind a bf16 conv on the path."""
    jin = [jnp.asarray(a) for a in inputs]
    j32, j16 = make_jax(None), make_jax(jnp.bfloat16)
    p = _init(j32, *jin, seed=seed)
    _load(torch_module, p, root, strip)
    tin = [_nchw(a) if nchw and a.ndim == 4 else torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        got32 = torch_module(*tin)
        set_compute_dtype(torch_module, torch.bfloat16)
        got16 = torch_module(*[t.to(torch.bfloat16) if bf16_inputs else t for t in tin])
    want32 = j32.apply({"params": p}, *jin)
    want16 = j16.apply({"params": p},
                       *[a.astype(jnp.bfloat16) if bf16_inputs else a for a in jin])
    assert got16.dtype == torch.bfloat16 and want16.dtype == jnp.bfloat16
    _four_way(got16, want16, got32, want32, nchw, type(torch_module).__name__)


# ---------------------------------------------- modules that hold a kernel

@pytest.mark.parametrize("act", [None, "swish"])
def test_group_norm_bf16(act):
    """K3/K4's module: a bf16 map in, f32 statistics and affine, bf16 out.
    GroupNorm has no weight to round, so the input is what is bf16."""
    from dc_vic_tpu.nn.layers import GroupNorm as JGN
    from dc_vic_tpu_torch.nn.layers import GroupNorm
    x32 = _x((2, 6, 5, 64), scale=3.0) + 2.0
    x16 = jnp.asarray(x32).astype(jnp.bfloat16)
    jm = JGN(num_groups=32, act=act, dtype=jnp.bfloat16)
    p = _init(jm, jnp.asarray(x32))
    tm = GroupNorm(32, 64, act=act)
    tm.load_state_dict({"weight": torch.from_numpy(np.asarray(p["scale"])),
                        "bias": torch.from_numpy(np.asarray(p["bias"]))})
    t16 = _nchw(x32).to(torch.bfloat16)
    got16, got32 = tm(t16), tm(_nchw(x32))
    want16 = jm.apply({"params": p}, x16)
    want32 = JGN(num_groups=32, act=act).apply({"params": p}, jnp.asarray(x32))
    assert got16.dtype == torch.bfloat16 and want16.dtype == jnp.bfloat16
    assert tm.weight.dtype == torch.float32
    _four_way(got16, want16, got32, want32, what="GroupNorm")


@pytest.mark.parametrize("k,stride", [(3, 1), (5, 2), (1, 1)])
def test_conv_bf16(k, stride):
    """K5's module (3x3) and the other conv shapes of the stacks."""
    from dc_vic_tpu.nn.layers import Conv as JConv
    from dc_vic_tpu_torch.nn.layers import conv
    _module_four_way(lambda d: JConv(16, k, stride, dtype=d), conv(8, 16, k, stride),
                     ("encoder", "conv1"), "encoder.conv1.", _x((2, 12, 10, 8)))


def test_conv3x3_kernel_route_gets_bf16_operands(any_shape, monkeypatch):
    """With ``conv3x3`` and ``gn`` on, bf16 tensors reach the kernels' entry
    points as bf16, not widened to f32."""
    from dc_vic_tpu_torch.nn.layers import GroupNorm, conv
    from dc_vic_tpu_torch.ops import conv3x3, gn
    seen = []
    real_conv, real_sums = conv3x3.conv3x3_same, gn.channel_sums
    monkeypatch.setattr(conv3x3, "conv3x3_same",
                        lambda x, w: seen.append((x.dtype, w.dtype)) or real_conv(x, w))
    monkeypatch.setattr(gn, "channel_sums",
                        lambda x: seen.append((x.dtype,)) or real_sums(x))
    c, g = conv(16, 8, 3), GroupNorm(4, 8, act="swish")
    set_compute_dtype(c, torch.bfloat16)
    c.recon_kernel = g.recon_kernel = True
    with torch.no_grad():
        out = g(c(torch.from_numpy(_x((1, 16, 10, 12)))))
    assert out.dtype == torch.bfloat16
    assert seen == [(torch.bfloat16, torch.bfloat16), (torch.bfloat16,)]


def test_deconv_bf16():
    from dc_vic_tpu.nn.layers import DeconvTorch
    from dc_vic_tpu_torch.nn.layers import deconv
    _module_four_way(lambda d: DeconvTorch(12, dtype=d), deconv(8, 12),
                     ("decoder", "conv1"), "decoder.conv1.", _x((2, 5, 7, 8)))


@pytest.mark.parametrize("out_ch", [128, 256])
def test_fused_resblock_bf16(interpret_pallas, any_shape, monkeypatch, out_ch):
    """K6's module on its fused route in bf16 against the JAX block on its
    fused route in bf16 (Pallas kernel in interpret mode); out_ch 256 takes
    the 1x1 shortcut. The fused route must also stay near the unfused one."""
    from dc_vic_tpu.models import vqgan as J
    from dc_vic_tpu_torch.models.vqgan import VQResnetBlock
    x = _x((1, 8, 24, 128), seed=4, scale=0.7)
    j32 = J.VQResnetBlock(out_ch=out_ch)
    p = _init(j32, jnp.asarray(x))
    tm = _load(VQResnetBlock(128, out_ch), p, ("vq_model", "encoder", "down_1_block_0"),
               "vq_model.encoder.down.1.block.0.")
    with torch.no_grad():
        got32 = tm(_nchw(x))
        set_compute_dtype(tm, torch.bfloat16)
        unfused16 = tm(_nchw(x))
        tm.fused = True
        assert tm.takes_fused((1, 128, 8, 24))
        got16 = tm(_nchw(x))
    want32 = j32.apply({"params": p}, jnp.asarray(x))
    monkeypatch.setattr(J, "_use_fused_resblock", lambda *a: True)
    want16 = J.VQResnetBlock(out_ch=out_ch, dtype=jnp.bfloat16).apply(
        {"params": p}, jnp.asarray(x))
    assert got16.dtype == torch.bfloat16 and want16.dtype == jnp.bfloat16
    _four_way(got16, want16, got32, want32, what="fused VQResnetBlock")
    _close(_np(got16), _np(unfused16), _np(got32), BF16_TOL, "fused vs unfused bf16")


def test_vq_attn_block_bf16(monkeypatch):
    """K2's module: bf16 convs around it, f32 operands into the attention
    whatever the conv dtype, the sum cast back."""
    from dc_vic_tpu.models import vqgan as J
    from dc_vic_tpu_torch.models import vqgan
    seen = []
    real = vqgan.flash_attention
    monkeypatch.setattr(vqgan, "flash_attention",
                        lambda q, k, v: seen.append((q.dtype, k.dtype, v.dtype)) or real(q, k, v))
    _module_four_way(lambda d: J.VQAttnBlock(dtype=d), vqgan.VQAttnBlock(64),
                     ("vq_model", "encoder", "mid_attn_1"), "vq_model.encoder.mid.attn_1.",
                     _x((2, 6, 5, 64)))
    assert seen == [(torch.float32,) * 3] * 2


def test_vq_resnet_block_bf16():
    from dc_vic_tpu.models import vqgan as J
    from dc_vic_tpu_torch.models import vqgan
    _module_four_way(lambda d: J.VQResnetBlock(32, dtype=d), vqgan.VQResnetBlock(64, 32),
                     ("vq_model", "encoder", "down_1_block_0"),
                     "vq_model.encoder.down.1.block.0.", _x((2, 6, 5, 64)))


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_bf16(shift):
    """f32 scores and softmax inside bf16 tokens, f32 LayerNorm."""
    from dc_vic_tpu.nn.swin import SwinBlock as J
    from dc_vic_tpu_torch.nn.swin import SwinBlock
    tm = SwinBlock(16, 2, 4, shift_size=shift)
    _module_four_way(lambda d: J(16, num_heads=2, window_size=4, shift_size=shift, dtype=d),
                     tm, ("vq_estimator", "RSTB_0", "SwinBlock_1"),
                     "vq_estimator.swin_blks.0.residual_group.blocks.1.",
                     _x((2, 8, 12, 16)), nchw=False, bf16_inputs=True)
    assert tm.norm1.weight.dtype == torch.float32
    assert tm.attn.relative_position_bias_table.dtype == torch.float32
    assert tm.attn.qkv.weight.dtype == torch.bfloat16


def test_film_promotes_as_jax_does():
    """An f32 map through a bf16 FiLM stays f32 on both sides (f32 x bf16
    promotes to f32); the Fourier features stay f32, the MLP is bf16."""
    from dc_vic_tpu.nn.layers import BetaScaleShift as JB
    from dc_vic_tpu.nn.layers import DualBetaCondMLP
    from dc_vic_tpu_torch.nn.layers import BetaScaleShift, beta_cond, beta_mlp
    b1, b2 = jnp.array([2.29]), jnp.array([3.0])
    jm = DualBetaCondMLP(16, L=4, max_beta_1=3.0, max_beta_2=3.5, dtype=jnp.bfloat16)
    p = _init(jm, b1, b2)
    mlp = _load(beta_mlp(16, 4, True), p, ("encoder", "beta_mlp"), "encoder.mlp.")
    set_compute_dtype(mlp, torch.bfloat16)
    with torch.no_grad():
        cond = beta_cond(mlp, torch.tensor([2.29]), torch.tensor([3.0]), 4, 3.0, 3.5,
                         False, True)
    cond_j = jm.apply({"params": p}, b1, b2)
    assert cond.dtype == torch.bfloat16 and cond_j.dtype == jnp.bfloat16
    _close(_np(cond), _np(cond_j), _np(cond_j), BF16_TOL, "cond")
    x = _x((2, 5, 4, 12))
    jf = JB(12, dtype=jnp.bfloat16)
    pf = _init(jf, jnp.asarray(x), cond_j, seed=3)
    film = _load(BetaScaleShift(12, 16), pf, ("encoder", "beta_ft_0"),
                 "encoder.beta_ft_list.0.")
    set_compute_dtype(film, torch.bfloat16)
    with torch.no_grad():
        got = film(_nchw(x), cond)
    want = jf.apply({"params": pf}, jnp.asarray(x), cond_j)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(_np(got), _np(want), _np(want), BF16_TOL, "FiLM")


# ------------------------------------------------------------------ stacks

def test_vq_encoder_bf16():
    from dc_vic_tpu.models.vqgan import VQEncoder as J
    from dc_vic_tpu_torch.models.vqgan import VQEncoder
    _module_four_way(lambda d: J(**DD, dtype=d), VQEncoder(**DD), ("vq_model", "encoder"),
                     "vq_model.encoder.", _x((2, 32, 24, 3)))


_JAX_DECODER = {}     # the JAX results, shared by the two cases below


@pytest.mark.parametrize("kernels_on", [False, True])
def test_vq_decoder_with_sft_taps_bf16(kernels_on, any_shape):
    """The fused decoder in bf16, on the ordinary routes and with every
    reconstruction-kernel route taken."""
    from dc_vic_tpu.models.vqgan import VQDecoder as J
    from dc_vic_tpu_torch.models import RECON_KERNELS, set_recon_kernels
    from dc_vic_tpu_torch.models.dc_vic import FusionModule
    from dc_vic_tpu_torch.models.vqgan import VQDecoder
    z = _x((2, 8, 6, 4))
    cond = {"block_1_2": _x((2, 8, 6, 16), seed=2),
            "block_1_1": _x((2, 16, 12, 16), seed=3)}
    sched = {"block_1_2": {"mid_ch": 32}, "block_1_1": {"mid_ch": 16}}
    j32, j16 = J(**DD, fuse_schedule=sched), J(**DD, fuse_schedule=sched, dtype=jnp.bfloat16)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    p = _init(j32, jnp.asarray(z), jcond, 0.8)
    holder = nn.Module()
    holder.vq_model = nn.Module()
    holder.vq_model.decoder = VQDecoder(**DD)
    holder.fusion_module = FusionModule({
        "block_1_2": dict(dec_ch=64, cond_ch=16, mid_ch=32),
        "block_1_1": dict(dec_ch=32, cond_ch=16, mid_ch=16)})
    _load(holder, p, ("fused_decoder",), "")
    tcond = {k: _nchw(v) for k, v in cond.items()}
    run = lambda: holder.vq_model.decoder(_nchw(z), holder.fusion_module.fusion_modules,
                                          tcond, 0.8)
    with torch.no_grad():
        got32 = run()
        set_compute_dtype(holder, torch.bfloat16)
        if kernels_on:
            set_recon_kernels(holder, RECON_KERNELS)
        got16 = run()
    assert got16.dtype == torch.bfloat16
    if not _JAX_DECODER:
        _JAX_DECODER.update(
            want16=j16.apply({"params": p}, jnp.asarray(z), jcond, 0.8),
            want32=j32.apply({"params": p}, jnp.asarray(z), jcond, 0.8))
    _four_way(got16, _JAX_DECODER["want16"], got32, _JAX_DECODER["want32"],
              what="VQDecoder+SFT")


# ------------------------------------------------------ the model as a whole

def _build_pair(cfg_extra):
    """(JAX module, JAX params, port module) of the tiny model under
    ``cfg_extra``, on one set of f32 parameters made from a seed."""
    from dc_vic_tpu.models import build_comp_model as jax_build
    from dc_vic_tpu.models.convert import convert_state_dict, export_state_dict
    from dc_vic_tpu_torch.models import build_comp_model, init_weights
    from dc_vic_tpu_torch.models.convert import load_reference_state_dict
    cfg = dict(tiny_config(), **cfg_extra)
    m = jax_build(cfg).module
    template = flax_template(m, cfg)
    seed_model = build_comp_model(tiny_config(), device="cpu").module
    init_weights(seed_model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    sd = {k: v.numpy() + rng.normal(0, 0.02, v.shape).astype(np.float32)
          for k, v in seed_model.state_dict().items()}
    params, _ = convert_state_dict(sd, template, strict=True)
    spec = build_comp_model(cfg, device="cpu")
    load_reference_state_dict(spec.module, export_state_dict(params))
    return m, params, spec


@pytest.fixture(scope="module")
def pairs():
    """The bf16/default model pair, and the f32/high port on the same
    parameters."""
    from dc_vic_tpu.models.convert import export_state_dict
    from dc_vic_tpu_torch.models import build_comp_model
    from dc_vic_tpu_torch.models.convert import load_reference_state_dict
    m, params, spec16 = _build_pair(BF16_CFG)
    spec32 = build_comp_model(tiny_config(), device="cpu")
    load_reference_state_dict(spec32.module, export_state_dict(params))
    return {"bf16": (m, params, spec16), "f32": (None, None, spec32)}


def _jax_stages(m, params, img):
    """The JAX model's stacks on one batch, eagerly: encoder side, then the
    decode stacks on the JAX model's own y_hat stand-in (its rounded y)."""
    from dc_vic_tpu.models.dc_vic import to_model_range as jax_range
    b1, b2 = jnp.array([BETAS[0]]), jnp.array([BETAS[1]])
    out = {}
    x = jax_range(jnp.asarray(img))
    out["vq_h"] = m.apply(params, x, method=lambda mod, t: mod.vq_model.encode(t))
    out["y"], out["z_sym"] = m.apply(params, jnp.asarray(img), b1, b2, method=m.encode_front)
    return out


def _jax_decode(m, params, y_hat):
    b1, b2 = jnp.array([BETAS[0]]), jnp.array([BETAS[1]])
    out = {}
    out["feat"], out["cond"] = m.apply(
        params, y_hat, b1, b2, method=lambda mod, y, a, b: mod.decoder.get_feats(y, a, b))
    out["pred"], out["logits"] = m.apply(
        params, out["feat"], method=lambda mod, f: mod.vq_estimator(f))
    out["fake"] = m.apply(params, y_hat, b1, b2, method=m.decode_from_y_hat)[0]
    return out


@pytest.fixture(scope="module")
def staged(pairs):
    img = np.random.default_rng(1).integers(0, 256, (1, 128, 128, 3), dtype=np.uint8)
    y_hat = np.round(np.random.default_rng(2).standard_normal((1, 8, 8, 24)) * 3
                     ).astype(np.float32)
    m, params, _ = pairs["bf16"]
    return {"img": img, "y_hat": y_hat,
            "bf16": dict(_jax_stages(m, params, img),
                         **_jax_decode(m, params, jnp.asarray(y_hat)))}


def test_bf16_model_holds_bf16_stacks_and_f32_entropy_modules(pairs):
    """``load_reference_state_dict`` stays strict on a bf16 model: f32
    reference parameters land rounded in the conv stacks and untouched in
    the entropy modules, the norms, the position biases and the codebook."""
    from dc_vic_tpu.models.convert import export_state_dict
    from dc_vic_tpu_torch.models.convert import load_reference_state_dict
    _, params, spec = pairs["bf16"]
    port = spec.module
    assert (port.codec_dtype, port.entropy_precision) == ("bfloat16", "default")
    sd = export_state_dict(params)
    for k, v in port.state_dict().items():
        f32 = (k.startswith(("hyperdecoder.", "context_model.", "entropy_model_z."))
               or ".norm" in k or "norm_out" in k or "relative_position" in k
               or "embedding" in k)
        assert v.dtype == (torch.float32 if f32 else torch.bfloat16), k
        want = torch.from_numpy(np.ascontiguousarray(sd[k])).reshape(v.shape)
        assert torch.equal(v, want.to(v.dtype)), k
    with pytest.raises(KeyError):
        load_reference_state_dict(port, {k: v for k, v in sd.items()
                                         if k != "encoder.conv1.weight"})


def test_config_keys_are_validated():
    from dc_vic_tpu_torch.models import build_comp_model
    for bad in (dict(codec_dtype="float16"), dict(entropy_precision="fast")):
        with pytest.raises(ValueError):
            build_comp_model(dict(tiny_config(), **bad), device="cpu")
    for ok in (dict(codec_dtype="float32"), dict(entropy_precision="highest"),
               dict(codec_dtype=None, entropy_precision=None)):
        spec = build_comp_model(dict(tiny_config(), **ok), device="cpu")
        assert all(p.dtype == torch.float32 for p in spec.module.parameters())


def test_encoder_stacks_bf16(pairs, staged):
    """VQGAN encode -> f32 -> quantizer (K1 sees f32), the ELIC encoder and
    the hyperencoder, each widened to f32 exactly once on the way out."""
    port16, port32 = pairs["bf16"][2].module, pairs["f32"][2].module
    from dc_vic_tpu_torch.models.dc_vic import to_model_range
    x = to_model_range(_nchw(staged["img"]))
    got = {}
    with torch.no_grad():
        for name, port in (("bf16", port16), ("f32", port32)):
            h = port.vq_model.encode(x)
            lat, idx = port.vq_encode(x)
            y, z_sym = port.encode_front(_nchw(staged["img"]), torch.tensor([BETAS[0]]),
                                         torch.tensor([BETAS[1]]))
            got[name] = dict(vq_h=h, y=y, lat=lat, idx=idx)
            assert (lat.dtype, y.dtype, z_sym.dtype) == (torch.float32, torch.float32,
                                                         torch.int16)
    assert got["bf16"]["vq_h"].dtype == torch.bfloat16
    assert staged["bf16"]["vq_h"].dtype == jnp.bfloat16
    assert staged["bf16"]["y"].dtype == jnp.float32
    for key in ("vq_h", "y"):
        _four_way(got["bf16"][key], staged["bf16"][key], got["f32"][key], what=key)
    # y came out of bf16 arithmetic: every value is a bf16 value, on both sides
    y16 = got["bf16"]["y"]
    assert torch.equal(y16, y16.to(torch.bfloat16).float())
    yj = np.asarray(staged["bf16"]["y"])
    assert np.array_equal(yj, np.asarray(jnp.asarray(yj).astype(jnp.bfloat16), np.float32))
    # the quantizer is f32 and exact: fed the JAX latent it gives the JAX indices
    from dc_vic_tpu.models.dc_vic import to_model_range as jax_range
    m, params, _ = pairs["bf16"]
    _, idx_j = m.apply(params, jax_range(jnp.asarray(staged["img"])), method=m.vq_encode)
    h_j = _nchw(np.asarray(staged["bf16"]["vq_h"], np.float32))
    with torch.no_grad():
        _, idx = port16.vq_model.quantize(h_j)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))


def test_decode_stacks_bf16(pairs, staged):
    """ELIC get_feats (f32 y_hat in, cast by the first conv it meets), the
    Swin VQ estimator, and decode_from_y_hat as a whole."""
    port16, port32 = pairs["bf16"][2].module, pairs["f32"][2].module
    b1, b2 = torch.tensor([BETAS[0]]), torch.tensor([BETAS[1]])
    y_hat = _nchw(staged["y_hat"])
    got = {}
    with torch.no_grad():
        for name, port in (("bf16", port16), ("f32", port32)):
            feat, cond = port.decoder.get_feats(y_hat, b1, b2)
            # the estimator on the JAX feature, so that it is judged alone
            jfeat = _nchw(np.asarray(staged["bf16"]["feat"], np.float32)).to(feat.dtype)
            pred, logits = port.vq_estimator(jfeat)
            fake = port.decode_from_y_hat(y_hat, b1, b2)[0]
            got[name] = dict(feat=feat, pred=pred, logits=logits, fake=fake,
                             **{f"cond_{k}": v for k, v in cond.items()})
            assert fake.dtype == torch.float32
    assert got["bf16"]["feat"].dtype == torch.bfloat16
    assert staged["bf16"]["feat"].dtype == jnp.bfloat16
    for key in ("feat", "pred", "logits"):
        _four_way(got["bf16"][key], staged["bf16"][key], got["f32"][key], what=key)
    for k in staged["bf16"]["cond"]:
        _four_way(got["bf16"][f"cond_{k}"], staged["bf16"]["cond"][k],
                  got["f32"][f"cond_{k}"], what=f"cond {k}")
    # the image depends on the estimator's argmax: hold it only where both
    # sides chose the same codewords everywhere
    with torch.no_grad():
        idx = port16.decode_from_y_hat(y_hat, b1, b2)[3]
    m, params, _ = pairs["bf16"]
    idx_j = m.apply(params, jnp.asarray(staged["y_hat"]), jnp.array([BETAS[0]]),
                    jnp.array([BETAS[1]]), method=m.decode_from_y_hat)[3]
    flips = float((idx.numpy() != np.asarray(idx_j)).mean())
    assert flips <= 0.05, f"{flips:.3f} of the estimator's indices differ"
    if flips == 0:
        _close(_np(got["bf16"]["fake"]), _np(staged["bf16"]["fake"]),
               _np(got["f32"]["fake"]), BF16_TOL, "decode_from_y_hat image")


def test_entropy_chain_is_bitwise_the_f32_port_s_and_matches_jax(pairs):
    """hyper_decode, charm_slice_params and charm_decode_step under bf16 +
    ``default``: the entropy modules are f32 and the precision is a no-op
    on the CPU, so the port's results equal the f32/``high`` port's bitwise,
    and match the JAX model built the same way within atol = rtol = 1e-3
    (the tolerance tests/test_torch_model.py holds the f32 chain to)."""
    m, params, spec16 = pairs["bf16"]
    port16, port32 = spec16.module, pairs["f32"][2].module
    rng = np.random.default_rng(5)
    z_sym = rng.integers(-4, 5, (2, 2, 2, 16)).astype(np.int16)
    sym = rng.integers(-3, 4, (6, 2, 8, 8, 4)).astype(np.int16)
    tol = dict(atol=1e-3, rtol=1e-3)
    nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()
    with torch.no_grad():
        ho16, zh16 = port16.hyper_decode(_nchw(z_sym))
        ho32, zh32 = port32.hyper_decode(_nchw(z_sym))
        assert torch.equal(ho16, ho32) and torch.equal(zh16, zh32)
        ho_j, _ = m.apply(params, jnp.asarray(z_sym), method=m.hyper_decode)
        np.testing.assert_allclose(nhwc(ho16), np.asarray(ho_j), **tol)
        prev16 = prev32 = torch.zeros(2, 0, 8, 8)
        prev_j = jnp.zeros((2, 8, 8, 0), jnp.float32)
        mu16, idx16 = port16.charm_slice_params(0, ho16, prev16)
        mu32, idx32 = port32.charm_slice_params(0, ho32, prev32)
        mu_j, _ = m.apply(params, 0, ho_j, prev_j, method=m.charm_slice_params)
        for i in range(6):
            assert torch.equal(mu16, mu32) and torch.equal(idx16, idx32)
            np.testing.assert_allclose(nhwc(mu16), np.asarray(mu_j), **tol)
            s = _nchw(sym[i])
            prev16, mu16, idx16 = port16.charm_decode_step(i, ho16, prev16, s, mu16)
            prev32, mu32, idx32 = port32.charm_decode_step(i, ho32, prev32, s, mu32)
            prev_j, mu_j, _ = m.apply(params, i, ho_j, prev_j, jnp.asarray(sym[i]), mu_j,
                                      method=m.charm_decode_step)
            assert torch.equal(prev16, prev32)
            np.testing.assert_allclose(nhwc(prev16), np.asarray(prev_j), **tol)


def test_entropy_precision_scope_restores_the_flag(pairs):
    """``default`` allows TF32 inside the three chain methods only, and puts
    the process-wide flag back even when the chain raises; ``high`` never
    touches it."""
    port16, port32 = pairs["bf16"][2].module, pairs["f32"][2].module
    before = torch.backends.cudnn.allow_tf32
    seen = []
    try:
        torch.backends.cudnn.allow_tf32 = False
        for port in (port16, port32):
            with port._entropy_convs():
                seen.append(torch.backends.cudnn.allow_tf32)
            assert torch.backends.cudnn.allow_tf32 is False
        assert seen == [True, False]
        hook = port16.hyperdecoder.register_forward_pre_hook(
            lambda mod, args: seen.append(torch.backends.cudnn.allow_tf32))
        with torch.no_grad():
            port16.hyper_decode(torch.zeros(1, 16, 1, 1, dtype=torch.int16))
        hook.remove()
        assert seen[-1] is True and torch.backends.cudnn.allow_tf32 is False
        with pytest.raises(RuntimeError):
            with torch.no_grad():
                port16.hyper_decode(torch.zeros(1, 3, 1, 1, dtype=torch.int16))
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cudnn.allow_tf32 = before


# ------------------------------------------------------- the slice as a whole

@pytest.fixture(scope="module")
def codecs(pairs):
    from dc_vic_tpu_torch.codec.driver import Codec
    spec = pairs["bf16"][2]
    with pytest.warns(UserWarning, match="entropy_precision"):
        parity = Codec(spec, stream_format="compressai")
    return {"tpu": Codec(spec, encode_backend="device", lanes=8), "compressai": parity}


@pytest.mark.parametrize("fmt", ["tpu", "compressai"])
@pytest.mark.parametrize("batch", [1, 2, 4])
def test_bf16_default_codec_round_trip_bit_exact(codecs, fmt, batch):
    """The deployment configuration end to end: the decoder's latents equal
    the encoder's bitwise and the decoded image is reconstruct_uint8 of the
    encoder's y_hat, in both formats."""
    codec = codecs[fmt]
    img = np.random.default_rng(batch).integers(0, 256, (batch, 96, 80, 3), dtype=np.uint8)
    res = codec.compress(img, 1, debug=True)
    strings = [r["string_list"] for r in res]
    assert codec.verify_roundtrip(res, strings, (96, 80))
    out = codec.decompress(strings)
    assert out.shape == (batch, 96, 80, 3) and out.dtype == np.uint8
    b1, b2 = codec._betas(1)
    y_hat = torch.from_numpy(np.ascontiguousarray(
        np.stack([r["y_hat"] for r in res]).transpose(0, 3, 1, 2)))
    with torch.no_grad():
        recon = codec.module.reconstruct_uint8(y_hat, b1, b2)
    np.testing.assert_array_equal(out, recon.permute(0, 2, 3, 1).numpy()[:, :96, :80])


def test_header_config_byte_equals_the_jax_codec_s(pairs, codecs):
    """Byte 8 of a tpu-format header (bit 0 fast entropy, bit 1 bf16) as the
    JAX Codec of the same configuration writes it."""
    from dc_vic_tpu.codec.container import HeaderHandler as JaxHeader
    from dc_vic_tpu.codec.driver import Codec as JaxCodec
    from dc_vic_tpu.models import build_comp_model as jax_build
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    _, params, _ = pairs["bf16"]
    jcodec = JaxCodec(jax_build(dict(tiny_config(), **BF16_CFG)), params)
    assert (jcodec._fast_entropy, jcodec._bf16) == (True, True)
    img = np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    header = codecs["tpu"].compress(img, 0)[0]["string_list"][0]
    hdr = HeaderHandler.decode(header)
    want = JaxHeader.encode((64, 64), 0, 0, tpu_format=True, lanes=8, encode_batch=1,
                            esc_dense=hdr["esc_dense"], t2free=hdr["t2free"],
                            escfree=hdr["escfree"], portable=False,
                            fast_entropy=jcodec._fast_entropy, bf16=jcodec._bf16)
    assert header == want and header[8] & 3 == 3
    assert (hdr["fast_entropy"], hdr["bf16"]) == (True, True)


def test_numeric_configuration_mismatch_raises(pairs, codecs):
    """A bf16/default stream fed to an f32/high codec raises, and the
    reverse."""
    from dc_vic_tpu_torch.codec.driver import Codec
    f32 = Codec(pairs["f32"][2], encode_backend="device", lanes=8)
    img = np.random.default_rng(3).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    s16 = [r["string_list"] for r in codecs["tpu"].compress(img, 0)]
    s32 = [r["string_list"] for r in f32.compress(img, 0)]
    with pytest.raises(ValueError, match="other setting"):
        f32.decompress(s16)
    with pytest.raises(ValueError, match="other setting"):
        codecs["tpu"].decompress(s32)
    assert f32.decompress(s32).shape == codecs["tpu"].decompress(s16).shape


def test_deployment_workload_is_seeded_and_scales_only_the_encoder():
    """tools/workload.py: the images are a function of the seed alone, the
    configuration copy sets the two numeric keys without touching its
    argument, and the rate scale reaches the encoder's parameters only."""
    from dc_vic_tpu_torch.tools.workload import (DEPLOYMENT, deployment_config,
                                                 deployment_images, scale_encoder)
    imgs = deployment_images()
    assert imgs.shape == (DEPLOYMENT["batch"], DEPLOYMENT["H"], DEPLOYMENT["W"], 3)
    assert imgs.dtype == np.uint8 and 0 < imgs.std() and (imgs[0] != imgs[1]).any()
    np.testing.assert_array_equal(imgs[:2], deployment_images()[:2])
    cfg = tiny_config()
    out = deployment_config(cfg)
    assert (out["codec_dtype"], out["entropy_precision"]) == ("bfloat16", "default")
    assert "codec_dtype" not in cfg or cfg["codec_dtype"] != "bfloat16"
    sd = {"encoder.a": torch.ones(2), "decoder.a": torch.ones(2)}
    scaled = scale_encoder(sd)
    assert torch.equal(scaled["encoder.a"], torch.full((2,), DEPLOYMENT["rate_scale"]))
    assert torch.equal(scaled["decoder.a"], sd["decoder.a"])
    assert scaled["decoder.a"] is not sd["decoder.a"]
