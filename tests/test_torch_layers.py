"""Each layer and block of the port against its flax twin on the same
weights and inputs (slice items: nn/layers.py, nn/swin.py, models/vqgan.py).

Flax parameters are perturbed with seeded noise (so biases and norm
affines are exercised), carried into the torch module through the JAX
package's own export mapping (models/convert.py::PathMapper), and both
modules run on the same seeded input in f32 on the CPU. Tolerance
atol = rtol = 1e-4: XLA:CPU and oneDNN sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch import nn

from dc_vic_tpu.models.convert import TRANSFORMS, PathMapper
from dc_vic_tpu_torch.models.convert import load_reference_state_dict

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _init(flax_module, *args, seed=0):
    """Flax params with seeded noise on every leaf."""
    params = flax_module.init(jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(params)
    for k, v in flat.items():
        v = np.asarray(v)
        flat[k] = v + rng.normal(0, 0.1 * (np.std(v) + 0.1), v.shape).astype(v.dtype)
    return traverse_util.unflatten_dict(flat)


def _load(torch_module, params, root, strip):
    """Map flax paths (under the model-level path ``root``) to reference
    torch keys, drop the ``strip`` prefix, and load strictly."""
    mapper = PathMapper()
    sd = {}
    for path, leaf in traverse_util.flatten_dict(params).items():
        key, tf = mapper.map_path(tuple(root) + path)
        assert key.startswith(strip), (key, strip)
        sd[key[len(strip):]] = TRANSFORMS[tf][1](np.asarray(leaf))
    load_reference_state_dict(torch_module, sd)
    return torch_module.eval()


def _x(shape, seed=1, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _check(got, want, nchw=True):
    got = got.detach()
    if nchw and got.dim() == 4:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _pair(jax_module, torch_module, root, strip, *inputs, seed=0):
    """Init the flax module on NHWC ``inputs``, load its weights into the
    torch module, and return (torch output on NCHW inputs, flax output)."""
    jin = [jnp.asarray(a) for a in inputs]
    p = _init(jax_module, *jin, seed=seed)
    _load(torch_module, p, root, strip)
    with torch.no_grad():
        got = torch_module(*[_nchw(a) for a in inputs])
    return got, jax_module.apply({"params": p}, *jin)


# ----------------------------------------------------------------- nn/layers

@pytest.mark.parametrize("act", [None, "swish"])
def test_group_norm_fast_variance(act):
    from dc_vic_tpu.nn.layers import GroupNorm as JGN
    from dc_vic_tpu_torch.nn.layers import GroupNorm
    x = _x((2, 6, 5, 64), scale=3.0) + 2.0
    jm = JGN(num_groups=32, act=act)
    p = _init(jm, jnp.asarray(x))
    tm = GroupNorm(32, 64, act=act)
    tm.load_state_dict({"weight": torch.from_numpy(np.asarray(p["scale"])),
                        "bias": torch.from_numpy(np.asarray(p["bias"]))})
    _check(tm(_nchw(x)), jm.apply({"params": p}, jnp.asarray(x)))


@pytest.mark.parametrize("k,stride", [(5, 2), (3, 1), (1, 1)])
def test_conv_torch_padding(k, stride):
    from dc_vic_tpu.nn.layers import Conv as JConv
    from dc_vic_tpu_torch.nn.layers import conv
    _check(*_pair(JConv(16, k, stride), conv(8, 16, k, stride),
                  ("encoder", "conv1"), "encoder.conv1.", _x((2, 12, 10, 8))))


def test_deconv_matches_dilated_conv():
    """DeconvTorch (input-dilated conv, flipped kernel) == ConvTranspose2d
    (k=5, s=2, p=2, output_padding=1) through the export transform."""
    from dc_vic_tpu.nn.layers import DeconvTorch
    from dc_vic_tpu_torch.nn.layers import deconv
    got, want = _pair(DeconvTorch(12), deconv(8, 12), ("hyperdecoder", "hd_mu", "conv1"),
                      "hyperdecoder.hd_mu.conv1.", _x((2, 5, 7, 8)))
    assert got.shape == (2, 12, 10, 14)
    _check(got, want)


def test_bottleneck_res_blocks():
    from dc_vic_tpu.nn.layers import ResidualBottleneckBlocks as J
    from dc_vic_tpu_torch.nn.layers import ResidualBottleneckBlocks
    _check(*_pair(J(16, 8, num_blocks=2, res_in_res=True),
                  ResidualBottleneckBlocks(16, 8, 2, True),
                  ("encoder", "block1"), "encoder.block1.", _x((2, 8, 6, 16))))


def test_cheng_nlam():
    from dc_vic_tpu.nn.layers import ChengNLAM as J
    from dc_vic_tpu_torch.nn.layers import ChengNLAM
    _check(*_pair(J(16), ChengNLAM(16), ("encoder", "attn2"), "encoder.attn2.",
                  _x((2, 8, 6, 16))))


def test_fourier_encode_beta():
    from dc_vic_tpu.nn.layers import fourier_encode_beta as jf
    from dc_vic_tpu_torch.nn.layers import fourier_encode_beta
    beta = np.array([0.0, 0.16, 1.12, 2.29, 3.0], np.float32)
    for use_pi, include_x in ((False, True), (True, False)):
        got = fourier_encode_beta(torch.from_numpy(beta), 10, 3.0, use_pi, include_x)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jf(jnp.asarray(beta), 10, 3.0, use_pi, include_x)),
            atol=1e-5, rtol=1e-5)


def test_dual_beta_cond_and_film():
    """DualBetaCondMLP (reference key mlp.{0,2}) and BetaScaleShift."""
    from dc_vic_tpu.nn.layers import BetaScaleShift as JB
    from dc_vic_tpu.nn.layers import DualBetaCondMLP
    from dc_vic_tpu_torch.nn.layers import BetaScaleShift, beta_cond, beta_mlp
    b1, b2 = jnp.array([2.29]), jnp.array([3.0])
    jm = DualBetaCondMLP(16, L=4, max_beta_1=3.0, max_beta_2=3.5)
    p = _init(jm, b1, b2)
    mlp = _load(beta_mlp(16, 4, True), p, ("encoder", "beta_mlp"), "encoder.mlp.")
    cond = beta_cond(mlp, torch.tensor([2.29]), torch.tensor([3.0]), 4, 3.0, 3.5,
                     False, True)
    cond_j = jm.apply({"params": p}, b1, b2)
    _check(cond, cond_j)

    x = _x((2, 5, 4, 12))
    jf = JB(12)
    pf = _init(jf, jnp.asarray(x), cond_j, seed=3)
    film = _load(BetaScaleShift(12, 16), pf, ("encoder", "beta_ft_0"),
                 "encoder.beta_ft_list.0.")
    _check(film(_nchw(x), cond), jf.apply({"params": pf}, jnp.asarray(x), cond_j))


def test_gn_resblocks_both_namings():
    """GNResBlock as the SFT trunk (codeformer keys, with the 1x1 shortcut)
    and as the estimator block (femasr keys)."""
    from dc_vic_tpu.nn.layers import GNResBlock as J
    from dc_vic_tpu_torch.nn.layers import FemasrResBlock, GNResBlock
    _check(*_pair(J(32), GNResBlock(48, 32),
                  ("fused_decoder", "fusion_block_1_8", "GNResBlock_0"),
                  "fusion_module.fusion_modules.block_1_8.fuse_block.",
                  _x((2, 6, 5, 48))))
    _check(*_pair(J(32, act="silu"), FemasrResBlock(32),
                  ("vq_estimator", "GNResBlock_0"), "vq_estimator.first_block.2.",
                  _x((2, 6, 5, 32))))


def test_fuse_sft_block():
    from dc_vic_tpu.nn.layers import FuseSftBlock as J
    from dc_vic_tpu_torch.nn.layers import FuseSftBlock
    dec, cond = _x((2, 6, 5, 32)), _x((2, 6, 5, 16), seed=2)
    jm = J(dec_ch=32, mid_ch=32)
    p = _init(jm, jnp.asarray(dec), jnp.asarray(cond), 0.7)
    tm = _load(FuseSftBlock(32, 16, 32), p, ("fused_decoder", "fusion_block_1_8"),
               "fusion_module.fusion_modules.block_1_8.")
    _check(tm(_nchw(dec), _nchw(cond), 0.7),
           jm.apply({"params": p}, jnp.asarray(dec), jnp.asarray(cond), 0.7))


# ------------------------------------------------------------------ nn/swin

@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block(shift):
    """Window attention with relative-position bias, and the shifted
    windows with their attention mask."""
    from dc_vic_tpu.nn.swin import SwinBlock as J
    from dc_vic_tpu_torch.nn.swin import SwinBlock
    x = _x((2, 8, 12, 16))
    jm = J(16, num_heads=2, window_size=4, shift_size=shift)
    p = _init(jm, jnp.asarray(x))
    tm = _load(SwinBlock(16, 2, 4, shift_size=shift), p,
               ("vq_estimator", "RSTB_0", "SwinBlock_1"),
               "vq_estimator.swin_blks.0.residual_group.blocks.1.")
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _check(got, jm.apply({"params": p}, jnp.asarray(x)), nchw=False)


def test_rstb():
    from dc_vic_tpu.nn.swin import RSTB as J
    from dc_vic_tpu_torch.nn.swin import RSTB
    _check(*_pair(J(16, depth=2, num_heads=2, window_size=4), RSTB(16, 2, 2, 4),
                  ("vq_estimator", "RSTB_0"), "vq_estimator.swin_blks.0.",
                  _x((2, 8, 12, 16))))


# ------------------------------------------------------------ models/vqgan

def test_vq_resnet_and_attn_blocks():
    """VQResnetBlock with and without the 1x1 shortcut, and VQAttnBlock
    (the K2 call site, plain version on the CPU)."""
    from dc_vic_tpu.models import vqgan as J
    from dc_vic_tpu_torch.models import vqgan
    x = _x((2, 6, 5, 64))
    _check(*_pair(J.VQResnetBlock(64), vqgan.VQResnetBlock(64, 64),
                  ("vq_model", "encoder", "mid_block_1"), "vq_model.encoder.mid.block_1.", x))
    _check(*_pair(J.VQResnetBlock(32), vqgan.VQResnetBlock(64, 32),
                  ("vq_model", "encoder", "down_1_block_0"),
                  "vq_model.encoder.down.1.block.0.", x))
    _check(*_pair(J.VQAttnBlock(), vqgan.VQAttnBlock(64),
                  ("vq_model", "encoder", "mid_attn_1"), "vq_model.encoder.mid.attn_1.", x))


def test_vq_down_and_upsample():
    """Downsample's asymmetric (0, 1) pad and Upsample's nearest x2."""
    from dc_vic_tpu.models import vqgan as J
    from dc_vic_tpu_torch.models import vqgan
    x = _x((2, 6, 5, 16))
    got, want = _pair(J.Downsample(), vqgan.Downsample(16),
                      ("vq_model", "encoder", "down_0_downsample"),
                      "vq_model.encoder.down.0.downsample.", x)
    assert got.shape == (2, 16, 3, 2)
    _check(got, want)
    _check(*_pair(J.Upsample(), vqgan.Upsample(16),
                  ("vq_model", "decoder", "up_1_upsample"),
                  "vq_model.decoder.up.1.upsample.", x))


DD = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(16,),
          resolution=32, z_channels=4)


def test_vq_encoder():
    from dc_vic_tpu.models.vqgan import VQEncoder as J
    from dc_vic_tpu_torch.models.vqgan import VQEncoder
    _check(*_pair(J(**DD), VQEncoder(**DD), ("vq_model", "encoder"),
                  "vq_model.encoder.", _x((2, 32, 24, 3))))


def test_vq_decoder_with_sft_taps():
    """The fused decoder: VQGAN decoder keys under vq_model.decoder, the SFT
    blocks under fusion_module, taps after levels 1 and 0."""
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
    with torch.no_grad():
        got = holder.vq_model.decoder(_nchw(z), holder.fusion_module.fusion_modules,
                                      {k: _nchw(v) for k, v in cond.items()}, 0.8)
    assert got.shape == (2, 3, 16, 12)
    _check(got, jm.apply({"params": p}, jnp.asarray(z), jcond, 0.8))


def test_vector_quantizer():
    """Indices equal (the K1 call site), latents in the straight-through
    form the JAX quantizer returns."""
    from dc_vic_tpu.models.vqgan import VectorQuantizer as J
    from dc_vic_tpu_torch.models.vqgan import VectorQuantizer
    z = _x((2, 6, 5, 4), scale=0.02)
    jm = J(n_embed=64, embed_dim=4)
    p = _init(jm, jnp.asarray(z))
    tm = _load(VectorQuantizer(64, 4), p, ("vq_model", "quantize"), "vq_model.quantize.")
    with torch.no_grad():
        zq, idx = tm(_nchw(z))
    zq_j, _, idx_j = jm.apply({"params": p}, jnp.asarray(z))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    _check(zq, zq_j)
