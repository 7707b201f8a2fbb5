"""The alternative modules of the port against their flax twins at small
widths, f32, on the same weights: PixelShuffleUp and the ELIC up-convs,
GNResBlock's activations, LightFuseSftBlock and ``fuse_type``, GDN and its
inverse (at their init and off it), the VQ-insertion encoders
(ElicVqScEncoder, ElicVqEmbCatEncoder, ElicDualBetaFtVqEmbCatEncoder), the
pixel-shuffle ELIC fusion decoders, the plain ElicEncoder / ElicDecoder,
Balle'18, Cheng'20 and Test, and the ``double_z`` VQGAN encoder.

Weights: the port module's seeded init plus N(0, 0.02), carried into the
flax tree by inverting the port's converter (``variant_helpers.carry``: each
flax element written once) and loaded back into the port strictly. The
flax side runs eagerly. Outputs agree within atol = rtol = 1e-3, the model
tests' tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from train_helpers import TOL
from variant_helpers import carry, seeded_state_dict

from dc_vic_tpu.models import alt_autoencoders as jalt
from dc_vic_tpu.models import subnets as jsub
from dc_vic_tpu.models.convert import export_state_dict
from dc_vic_tpu.models.vqgan import VQModel as JaxVQModel
from dc_vic_tpu.nn import layers as jl
from dc_vic_tpu.utils.registry import DECODER_REGISTRY as JAX_DECODERS
from dc_vic_tpu.utils.registry import ENCODER_REGISTRY as JAX_ENCODERS
from dc_vic_tpu_torch.models import alt_autoencoders, subnets
from dc_vic_tpu_torch.models import convert
from dc_vic_tpu_torch.models.dc_vic import FusionModule
from dc_vic_tpu_torch.models.vqgan import VQModel
from dc_vic_tpu_torch.nn import layers
from dc_vic_tpu_torch.utils.registry import DECODER_REGISTRY, ENCODER_REGISTRY

ELIC = dict(main_ch=16, block_mid_ch=8, num_blocks=1)
BETA = dict(max_beta_1=3.0, max_beta_2=3.5, cond_ch=16, L=4)
FUSION = {"block1": "block_1_8", "block2": "block_1_4", "block3": "block_1_2"}


def _rand(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _pair(flax_mod, port, to_port, *args, **kw):
    """(flax params, port) with the port's seeded weights in both; ``args``
    are the flax call's inputs."""
    template = jax.eval_shape(lambda r: flax_mod.init(r, *args, **kw), jax.random.PRNGKey(0))
    sd = seeded_state_dict(port)
    params = carry(template["params"], sd, to_port)
    convert.load_reference_state_dict(port, to_port(params))
    return {"params": params}, port.eval()


def _check(got, want):
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


class _Holder(torch.nn.Module):
    def __init__(self, **children):
        super().__init__()
        for k, v in children.items():
            setattr(self, k, v)


def test_pixel_shuffle_up_matches_flax():
    """PixelShuffleUp: the flax reshape is torch's PixelShuffle channel
    order, so conv then nn.PixelShuffle(2) is the same map."""
    x = _rand((2, 8, 8, 6), 1)
    jm = jl.PixelShuffleUp(features=4, kernel=5)
    holder = _Holder(up=layers.pixel_shuffle_up(6, 4, 5))

    def to_port(t):
        out = {}
        convert._pixel_shuffle(out, "up", t)
        return out
    params, port = _pair(jm, holder, to_port, jnp.asarray(x))
    with torch.no_grad():
        _check(_nhwc(port.up(_nchw(x))), jm.apply(params, jnp.asarray(x)))
    assert isinstance(layers.up_conv(6, 4, True)[1], torch.nn.PixelShuffle)
    assert isinstance(layers.up_conv(6, 4, False), torch.nn.ConvTranspose2d)


@pytest.mark.parametrize("act", ["swish", "silu", "leakyrelu", "gelu", "relu"])
def test_gn_resblock_activations_match_flax(act):
    """GNResBlock's ``act`` in the estimator's femasr block: swish fused into
    the norms; leakyrelu's slope 0.2; gelu as flax's tanh approximation."""
    x = _rand((2, 8, 8, 16), 2, -2, 2)
    jm = jl.GNResBlock(out_ch=16, act=act)
    block = layers.FemasrResBlock(16, act)

    def to_port(t):
        out = {}
        for norm, pos in (("GroupNorm_0", 0), ("GroupNorm_1", 3)):
            out[f"conv.{pos}.norm.weight"] = np.asarray(t[norm]["scale"])
            out[f"conv.{pos}.norm.bias"] = np.asarray(t[norm]["bias"])
        convert._conv(out, "conv.2", t["Conv_0"])
        convert._conv(out, "conv.5", t["Conv_1"])
        return out
    params, port = _pair(jm, block, to_port, jnp.asarray(x))
    with torch.no_grad():
        _check(_nhwc(port(_nchw(x))), jm.apply(params, jnp.asarray(x)))
    fused = act in ("swish", "silu")
    assert isinstance(block.conv[1], torch.nn.Identity) == fused
    assert (block.conv[0].norm.act == "swish") == fused


def test_light_fuse_sft_block_matches_flax():
    """LightFuseSftBlock through ``fusion_state_dict``: Conv_0..3 are the
    1x1 and 3x3 fuse convs, then scale and shift (not the full block's
    scale.0 / scale.2 / shift.0 / shift.2); every fuse_type but "sft"
    builds it, as in the JAX package."""
    dec, cond = _rand((2, 8, 8, 8), 3), _rand((2, 8, 8, 6), 4)
    jm = jl.LightFuseSftBlock(dec_ch=8, mid_ch=12)
    fm = FusionModule({"k": {"dec_ch": 8, "cond_ch": 6, "mid_ch": 12}}, "light_sft")
    holder = _Holder(fusion_module=fm)
    to_port = lambda t: convert.fusion_state_dict({"fusion_k": t})
    params, port = _pair(jm, holder, to_port, jnp.asarray(dec), jnp.asarray(cond), 0.7)
    with torch.no_grad():
        got = port.fusion_module.fusion_modules["k"](_nchw(dec), _nchw(cond), 0.7)
    _check(_nhwc(got), jm.apply(params, jnp.asarray(dec), jnp.asarray(cond), 0.7))
    for fuse_type, cls in (("sft", layers.FuseSftBlock), ("light_sft", layers.LightFuseSftBlock),
                           ("concat", layers.LightFuseSftBlock)):
        blk = FusionModule({"k": {"dec_ch": 8, "cond_ch": 6, "mid_ch": 8}}, fuse_type)
        assert type(blk.fusion_modules["k"]) is cls


@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_gdn_matches_flax_at_and_off_its_init(inverse):
    """GDN and inverse GDN: at their deterministic init (the port's equals
    flax's, no draw) and with the raw parameters moved, some below their
    bounds; ``gamma`` is the transpose of flax's ``gamma_raw``."""
    x = _rand((2, 4, 4, 8), 5, -3, 3)
    jm = jl.GDN(inverse=inverse)
    init = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = layers.GDN(8, inverse=inverse)
    np.testing.assert_array_equal(port.beta.detach().numpy(),
                                  np.asarray(init["params"]["beta_raw"]))
    np.testing.assert_array_equal(port.gamma.detach().numpy(),
                                  np.asarray(init["params"]["gamma_raw"]).T)
    rng = np.random.default_rng(6)
    moved = {"beta_raw": rng.uniform(-0.2, 2.0, 8).astype(np.float32),
             "gamma_raw": rng.uniform(-0.05, 0.5, (8, 8)).astype(np.float32)}
    for params in (jax.tree.map(np.asarray, init["params"]), moved):
        out = {}
        convert._gdn(out, "g", params)
        holder = _Holder(g=port)
        convert.load_reference_state_dict(holder, out)
        with torch.no_grad():
            _check(_nhwc(port(_nchw(x))), jm.apply({"params": params}, jnp.asarray(x)))


ENCODERS = {
    "ElicVqScEncoder": (dict(out_ch=24, **ELIC), 5, False, False),
    "ElicVqEmbCatEncoder": (dict(out_ch=24, vq_n_embed=32, vq_ind_embed_dim=8, **ELIC), 4,
                            True, False),
    "ElicDualBetaFtVqEmbCatEncoder": (dict(out_ch=24, vq_n_embed=32, vq_ind_embed_dim=8,
                                           **ELIC, **BETA), 4, True, True),
}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_vq_insertion_encoders_match_flax(name):
    """The encoders of ``norm_indices`` (1x1 projection of latent ++ index at
    /8) and ``long_indices`` (embedded token map in the 3x3 projection,
    N(0, 1) index embedding; the dual-beta one without FiLM 5)."""
    kw, feat_ch, takes_idx, beta = ENCODERS[name]
    x, feat = _rand((2, 64, 64, 3), 7), _rand((2, 8, 8, feat_ch), 8)
    idx = np.random.default_rng(9).integers(0, 32, (2, 8, 8)).astype(np.int32)
    jargs = [jnp.asarray(x), jnp.asarray(feat)]
    targs = [_nchw(x), _nchw(feat)]
    if beta:
        jargs += [jnp.array([1.7]), jnp.array([2.6])]
        targs += [torch.tensor([1.7]), torch.tensor([2.6])]
    if takes_idx:
        jargs.append(jnp.asarray(idx))
        targs.append(torch.from_numpy(idx))
    jm = getattr(jsub, name)(**kw)
    port = ENCODER_REGISTRY.get(name)(in_ch=3, input_feat_ch=feat_ch, **kw)
    params, port = _pair(jm, port, lambda t: convert.transform_state_dict(name, t), *jargs)
    with torch.no_grad():
        _check(_nhwc(port(*targs)), jm.apply(params, *jargs))
    if beta:
        assert sorted(port.beta_ft_list, key=int) == ["0", "1", "2", "3", "4", "6", "7", "8"]
    if takes_idx:
        fresh = ENCODER_REGISTRY.get(name)(in_ch=3, input_feat_ch=feat_ch, **kw)
        from dc_vic_tpu_torch.models import init_weights
        init_weights(fresh, torch.Generator().manual_seed(1))
        emb = fresh.vq_ind_emb.weight.detach()
        assert isinstance(fresh.vq_ind_emb, subnets.IndexEmbedding)
        assert 0.7 < float(emb.std()) < 1.3 and float(emb.abs().max()) > 1.0 / 32


@pytest.mark.parametrize("beta", [False, True], ids=["plain", "dual_beta"])
def test_pixel_shuffle_fusion_decoders_match_flax(beta):
    """The ELIC fusion decoders with ``pixel_shuffle``: the feature and the
    fusion taps of get_feats (up-convs ``PixelShuffleUp_i`` -> ``conv{i+1}.0``)."""
    y = _rand((2, 4, 4, 24), 10, -3, 3)
    kw = dict(fusion_layer_dict=FUSION, feat_layer_name="block1", out_ch=3, pixel_shuffle=True,
              **ELIC, **(BETA if beta else {}))
    name = "ElicDualBetaFtFeatFusionDecoder" if beta else "ElicFeatFusionDecoder"
    jm = getattr(jsub, name)(**kw)
    jargs = [jnp.asarray(y)] + ([jnp.array([0.4]), jnp.array([3.1])] if beta else [])
    targs = [_nchw(y)] + ([torch.tensor([0.4]), torch.tensor([3.1])] if beta else [])
    port = DECODER_REGISTRY.get(name)(in_ch=24, **kw)
    assert isinstance(port.conv1[1], torch.nn.PixelShuffle)
    params, port = _pair(jm, port, lambda t: convert.transform_state_dict(name, t), *jargs)
    want_feat, want_taps = jm.apply(params, *jargs, method=jm.get_feats)
    with torch.no_grad():
        feat, taps = port.get_feats(*targs)
    _check(_nhwc(feat), want_feat)
    assert sorted(taps) == sorted(want_taps)
    for k in taps:
        _check(_nhwc(taps[k]), want_taps[k])


@pytest.mark.parametrize("pixel_shuffle", [False, True], ids=["deconv", "pixel_shuffle"])
def test_elic_encoder_and_decoder_match_flax(pixel_shuffle):
    """The standalone ElicEncoder -> ElicDecoder (its anonymous children:
    up-convs, ``ResidualBottleneckBlocks_i``, ``ChengNLAM_0``), tanh on."""
    x = _rand((2, 64, 64, 3), 11)
    jenc, jdec = jsub.ElicEncoder(out_ch=24, **ELIC), jsub.ElicDecoder(
        out_ch=3, pixel_shuffle=pixel_shuffle, **ELIC)
    penc = ENCODER_REGISTRY.get("ElicEncoder")(in_ch=3, out_ch=24, **ELIC)
    pdec = DECODER_REGISTRY.get("ElicDecoder")(in_ch=24, out_ch=3, pixel_shuffle=pixel_shuffle,
                                               **ELIC)
    eparams, penc = _pair(jenc, penc, lambda t: convert.transform_state_dict("ElicEncoder", t),
                          jnp.asarray(x))
    y = jenc.apply(eparams, jnp.asarray(x))
    dparams, pdec = _pair(jdec, pdec, lambda t: convert.transform_state_dict("ElicDecoder", t),
                          y)
    with torch.no_grad():
        ty = penc(_nchw(x))
        _check(_nhwc(ty), y)
        _check(_nhwc(pdec(_nchw(np.asarray(y)))), jdec.apply(dparams, y))


ALT = {
    "Balle18": (dict(main_ch=16), dict(main_ch=16, use_tanh=False)),
    "Cheng20": (dict(main_ch=16), dict(main_ch=16, use_tanh=False)),
    "Test": ({}, {}),
}


@pytest.mark.parametrize("family", sorted(ALT))
def test_alternative_autoencoders_match_flax(family):
    """Balle18, Cheng20 and Test encoder -> decoder through
    ``transform_state_dict``'s call-order maps (two anonymous Cheng NLAMs
    each, GDN / inverse GDN, pixel-shuffle residual blocks). The decoders
    are compared before their tanh: with random weights the inverse GDNs
    grow Cheng'20's output to about 1e5, where f32 rounding alone (port and
    flax alike, against float64) moves values near zero by 0.2, so the
    decoders' absolute tolerance is 1e-3 of the output's largest
    magnitude."""
    ekw, dkw = ALT[family]
    x = _rand((2, 64, 64, 3), 12)
    enc_name, dec_name = f"{family}Encoder", f"{family}Decoder"
    jenc = getattr(jalt, enc_name)(out_ch=24, **ekw)
    jdec = getattr(jalt, dec_name)(out_ch=3, **dkw)
    penc = ENCODER_REGISTRY.get(enc_name)(in_ch=3, out_ch=24, **ekw)
    pdec = DECODER_REGISTRY.get(dec_name)(in_ch=24, out_ch=3, **dkw)
    eparams, penc = _pair(jenc, penc, lambda t: convert.transform_state_dict(enc_name, t),
                          jnp.asarray(x))
    y = jenc.apply(eparams, jnp.asarray(x))
    dparams, pdec = _pair(jdec, pdec, lambda t: convert.transform_state_dict(dec_name, t), y)
    want = np.asarray(jdec.apply(dparams, y))
    with torch.no_grad():
        _check(_nhwc(penc(_nchw(x))), y)
        np.testing.assert_allclose(_nhwc(pdec(_nchw(np.asarray(y)))), want, rtol=1e-3,
                                   atol=1e-3 * max(1.0, float(np.abs(want).max())))
    if family != "Test":
        assert DECODER_REGISTRY.get(dec_name)(main_ch=16).use_tanh


def test_double_z_vqgan_encoder_matches_flax():
    """``double_z``: conv_out gives 2 * z_channels and quant_conv takes
    them; the VQGAN's pre-quant latent against flax's (JAX path map)."""
    dd = {"double_z": True, "z_channels": 4, "resolution": 64, "in_channels": 3, "out_ch": 3,
          "ch": 8, "ch_mult": [1, 1, 1, 2], "num_res_blocks": 1, "attn_resolutions": [8]}
    x = _rand((2, 64, 64, 3), 13)
    jm = JaxVQModel(n_embed=32, embed_dim=4, ddconfig=dd)
    port = VQModel(32, 4, dd)
    assert port.encoder.conv_out.out_channels == 8 and port.quant_conv.in_features == 8
    holder = _Holder(vq_model=port)
    to_port = lambda t: export_state_dict({"params": {"vq_model": t}})
    params, holder = _pair(jm, holder, to_port, jnp.asarray(x))
    with torch.no_grad():
        _check(_nhwc(holder.vq_model.encode(_nchw(x))),
               jm.apply(params, jnp.asarray(x), method=jm.encode))


def test_every_registered_transform_builds():
    """Every name of the JAX package's encoder and decoder registries is
    registered in the port and builds on the CPU at its defaults."""
    assert set(JAX_ENCODERS._obj_map) <= set(ENCODER_REGISTRY._obj_map)
    assert set(JAX_DECODERS._obj_map) <= set(DECODER_REGISTRY._obj_map)
    for reg, names in ((ENCODER_REGISTRY, JAX_ENCODERS._obj_map),
                       (DECODER_REGISTRY, JAX_DECODERS._obj_map)):
        for name in names:
            kw = {"fusion_layer_dict": FUSION} if "Fusion" in name else {}
            with torch.device("meta"):
                m = reg.get(name)(**kw)
            assert sum(p.numel() for p in m.parameters()) > 0, name
    assert alt_autoencoders.Cheng20Encoder.__module__.endswith("alt_autoencoders")
