"""The model options of the port against the JAX model, at the tiny widths
of ``tests/helpers.py::tiny_config``, through ``tools/workload.py``'s two
variants (the overrides ``chip_smoke.py`` runs at full width):

* A, dual-beta ChARM (``variant_a``): ``long_indices`` into
  ElicDualBetaFtVqEmbCatEncoder, the VQGAN recon beside the image, the
  image in [0, 1], pixel-shuffle decoder, light SFT fusion, gelu estimator;
* B, single-beta ChARM (``variant_b``): ``norm_indices`` into
  ElicVqScEncoder, a ``double_z`` VQGAN encoder, leaky-ReLU estimator.

Weights: the port's seeded init plus N(0, 0.02), carried into flax by
inverting the port's converter for the encoder, the decoder and the fusion
blocks and the JAX path map for the rest (``variant_helpers``); the JAX
model's separate ``vq_model/decoder`` gets ``fused_decoder``'s VQGAN
leaves. Floats agree within atol = rtol = 1e-3; the compressai streams'
bytes are the JAX Codec's; one y section through the plain R1 and R2 codes
as the JAX device coder. Variant A's RD step: every trained tensor's
gradient (the index embedding and the light blocks among them) within a
relative L2 error of 1e-3 (+1e-7) (tests/test_torch_alt_options.py). Under
the deployment numerics (``codec_dtype: bfloat16``) each variant's decode
stacks are held to the JAX model built the same way, on the same weights.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from variant_helpers import BETAS, VARIANTS, carried, check_eval_forward, model_state_dict

from dc_vic_tpu.codec.driver import Codec as JaxCodec
from dc_vic_tpu.ops import rans_device as jrd
from dc_vic_tpu_torch.codec.driver import Codec
from dc_vic_tpu_torch.ops import rans_device as rd

H, W = 96, 80                      # pads to 128 x 128: y 8 x 8 x 24


def _images(seed, batch=2):
    return np.random.default_rng(seed).integers(0, 256, (batch, H, W, 3), dtype=np.uint8)


def _strings(res):
    return [r["string_list"] for r in res]


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    cfg = VARIANTS[request.param]()
    jspec, params, spec = carried(cfg)
    return request.param, cfg, jspec, params, spec


BF16_TOL = 4e-2   # tests/test_torch_bf16.py's tolerance between two bf16 results


def test_variant_decode_stacks_bf16_match_jax(variant):
    """The deployment numerics (``codec_dtype: bfloat16``, ``entropy_precision:
    default``) on the variant's weights: the port's bf16 model and the JAX
    model built with the same keys, on one y_hat, through the ELIC decoder's
    features and conditions (A: pixel-shuffle upsampling, the dual-beta
    conditions the light SFT blocks read) and, on the JAX feature so that it
    is judged alone, the VQ estimator (A: gelu; B: leaky ReLU). The largest
    difference must stay under BF16_TOL times the largest |value| of the
    port's f32 result, and each bf16 result must differ from that f32 result:
    bf16 keeps 8 bits, and XLA:CPU and oneDNN round the bf16 sums at
    different places (tests/test_torch_bf16.py, whose stacks showed up to
    2.5e-2). The whole forward is not held: a rounding flip of y or of a
    codeword index moves the image by far more than that on random weights."""
    from dc_vic_tpu.models import build_comp_model as jax_build
    from dc_vic_tpu_torch.models import build_comp_model
    from dc_vic_tpu_torch.models.convert import load_reference_state_dict
    _, cfg, _, params, spec32 = variant
    cfg16 = dict(cfg, codec_dtype="bfloat16", entropy_precision="default")
    m16 = jax_build(cfg16).module
    port16 = build_comp_model(cfg16, device="cpu").module
    load_reference_state_dict(port16, model_state_dict(params))
    port16.eval()
    y_hat = np.round(np.random.default_rng(2).standard_normal((1, 8, 8, 24)) * 3
                     ).astype(np.float32)
    jb = (jnp.array([BETAS[0]]), jnp.array([BETAS[1]])) if m16.use_beta else ()
    tb = (torch.tensor([BETAS[0]]), torch.tensor([BETAS[1]])) if m16.use_beta else ()
    feat_j, cond_j = m16.apply(params, jnp.asarray(y_hat), *jb,
                               method=lambda mod, y, *b: mod.decoder.get_feats(y, *b))
    pred_j, logits_j = m16.apply(params, feat_j, method=lambda mod, f: mod.vq_estimator(f))
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))
    got = {}
    with torch.no_grad():
        for name, port in (("bf16", port16), ("f32", spec32.module)):
            feat, cond = port.decoder.get_feats(nchw(y_hat), *tb)
            pred, logits = port.vq_estimator(nchw(feat_j).to(feat.dtype))
            got[name] = dict(feat=feat, pred=pred, logits=logits,
                             **{f"cond {k}": c for k, c in cond.items()})
    want = dict(feat=feat_j, pred=pred_j, logits=logits_j,
                **{f"cond {k}": c for k, c in cond_j.items()})
    assert got["bf16"]["feat"].dtype == torch.bfloat16 and feat_j.dtype == jnp.bfloat16
    assert set(got["bf16"]) == set(want)
    for key, w in want.items():
        g16, g32 = (got[n][key].detach().float().permute(0, 2, 3, 1).numpy()
                    if got[n][key].dim() == 4 else got[n][key].detach().float().numpy()
                    for n in ("bf16", "f32"))
        scale = float(np.abs(g32).max())
        err = float(np.abs(g16 - np.asarray(w, np.float32)).max())
        assert np.isfinite(g16).all() and err <= BF16_TOL * scale, \
            f"{key}: port bf16 vs JAX bf16 {err:.3e} over {BF16_TOL} x {scale:.3e}"
        assert not np.array_equal(g16, g32), f"{key}: the bf16 result is the f32 result"


def test_variant_builds_the_options(variant):
    """Each override reaches its module: A's encoder reads the token map
    and the recon (6 image channels, a 4-wide feature), B's the normalized
    index (5 wide) and a double_z VQGAN."""
    name, _, jspec, _, spec = variant
    m = spec.module
    if name == "A":
        assert (m.enc_vq_input, m.enc_input_vq_recon, m.convert_img_range_to_01) == (
            "long_indices", True, True)
        assert m.encoder.conv1.in_channels == 6
        assert m.encoder.projection.in_channels == 4 + 16 + 32
        assert type(m.fusion_module.fusion_modules["block_1_8"]).__name__ == "LightFuseSftBlock"
        assert isinstance(m.decoder.conv1[1], torch.nn.PixelShuffle)
        assert isinstance(m.vq_estimator.first_block[2].conv[1], torch.nn.GELU)
    else:
        assert m.enc_vq_input == "norm_indices" and not m.use_beta
        assert m.encoder.projection.in_channels == 5
        assert m.vq_model.encoder.conv_out.out_channels == 8
        assert isinstance(m.vq_estimator.out_block[0].conv[4], torch.nn.LeakyReLU)
    assert (jspec.module.enc_vq_input, jspec.module.enc_input_vq_recon) == (
        m.enc_vq_input, m.enc_input_vq_recon)


def test_variant_eval_forward_matches_jax(variant):
    _, _, jspec, params, spec = variant
    check_eval_forward(jspec.module, params, spec.module)


@pytest.mark.parametrize("fmt", ["compressai", "tpu-host", "tpu-device"])
def test_variant_round_trips_bit_exactly(variant, fmt):
    """Both stream formats: the decoder's latents equal the encoder's
    bitwise and the decoded images are reconstruct_uint8 of the encoder's
    y_hat (through the [0, 1] conversion for A)."""
    _, _, _, _, spec = variant
    codec = (Codec(spec, stream_format="compressai") if fmt == "compressai" else
             Codec(spec, encode_backend=fmt.split("-")[1], lanes=8))
    res = codec.compress(_images(1), 1, debug=True)
    strings = _strings(res)
    assert codec.verify_roundtrip(res, strings, (H, W))
    y_hat = torch.from_numpy(np.ascontiguousarray(
        np.stack([r["y_hat"] for r in res]).transpose(0, 3, 1, 2)))
    b1, b2 = spec.quality_betas(1)
    with torch.no_grad():
        recon = spec.module.reconstruct_uint8(y_hat, torch.tensor([b1]), torch.tensor([b2]))
    np.testing.assert_array_equal(codec.decompress(strings),
                                  recon.permute(0, 2, 3, 1).numpy()[:, :H, :W])


def test_variant_compressai_streams_equal_the_jax_codec_s(variant):
    """The JAX package's Codec and the port's write the same compressai
    bytes on the same weights and images, and each decodes the other's."""
    _, _, jspec, params, spec = variant
    jcodec = JaxCodec(jspec, params, stream_format="compressai")
    codec = Codec(spec, stream_format="compressai")
    img = _images(4)
    jres = jcodec.compress(img, quality_ind=2, debug=True)
    res = codec.compress(img, 2, debug=True)
    assert _strings(jres) == _strings(res)
    assert codec.verify_roundtrip(res, _strings(jres), (H, W))
    assert jcodec.verify_roundtrip(jres, _strings(res), (H, W))


def test_variant_y_section_codes_as_the_jax_device_coder(variant):
    """The first of the six ChARM y sections of a tpu-format encode through
    the plain R1 and R2 against the JAX device coder's encode_stream,
    pack_streams and decode_section at lanes 8: words, counts, escapes,
    symbols, cursor and lane states exact."""
    _, _, _, _, spec = variant
    codec = Codec(spec, encode_backend="host", lanes=8)
    handle = codec.compress_dispatch(_images(6), 0)
    sym, idx = handle["out"]["syms"][0], handle["out"]["idxs"][0]
    B, sc, yH, yW = sym.shape
    table = codec._dtable("y")
    jtable = jrd.DeviceCdfTable(codec.y_table)
    packed, offsets, counts, esc, _ = rd.encode_pack(sym, idx, 1, 8, table)
    L = rd.section_lanes(sc * yH * yW, 8)
    s_np = rd.to_stream(sym, L).numpy().astype(np.int32)
    i_np = rd.to_stream(idx, L).numpy().astype(np.int32)
    vals, mask, jesc = jrd.encode_stream([(jnp.asarray(s_np), jnp.asarray(i_np))], jtable,
                                         with_esc_counts=True)
    jpacked, jcounts = jrd.pack_streams(vals, mask)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    n = int(counts.sum())
    np.testing.assert_array_equal(packed[:n].numpy().view(np.uint16), np.asarray(jpacked)[:n])
    np.testing.assert_array_equal(esc.numpy(), np.asarray(jesc))
    base = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    got, cur, state = rd.decode_section(packed[:n], base, torch.zeros(B, dtype=torch.int32),
                                        None, idx.contiguous(), (B, sc, yH, yW), 8, table,
                                        sparse_esc=True)
    jsym, jcur, jstate = jrd.decode_section(
        jnp.asarray(packed[:n].numpy().view(np.uint16)), jnp.asarray(base.numpy()),
        jnp.zeros((B,), jnp.int32), None, jnp.asarray(i_np), jtable, sparse_esc=True)
    np.testing.assert_array_equal(rd.to_stream(got, L).numpy(), np.asarray(jsym))
    np.testing.assert_array_equal(rd.to_stream(got, L).numpy(), s_np)
    np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur))
    np.testing.assert_array_equal(cur.numpy(), counts.numpy())
    np.testing.assert_array_equal(state.numpy().view(np.uint32), np.asarray(jstate))
