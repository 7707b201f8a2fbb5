"""The codec of the models without dual-beta conditioning or without ChARM
on the CPU: HyperpriorCharmVicModel (stage 1_1's type) and
HyperpriorVicModel (neither) at the tiny widths, in both stream formats.

Round trips are bit-exact (y_hat and z_hat, portable streams included) and
the decoded images are reconstruct_uint8 of the encoder's y_hat. The
integers equal the JAX package's on the same weights and images: the
compressai streams' bytes, and the y symbols and CDF indexes of the encode
chain. Without ChARM a tpu-format y stream is one section of yH * yW * Cy
symbols; the plain R1 and R2 code it as the JAX device coder does. A model
without beta conditioning ignores the betas it is given.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from helpers import tiny_config
from train_helpers import TOL, flax_template

from dc_vic_tpu.codec.driver import Codec as JaxCodec
from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import convert_state_dict, export_state_dict
from dc_vic_tpu.ops import rans_device as jrd
from dc_vic_tpu_torch.codec.container import HeaderHandler
from dc_vic_tpu_torch.codec.driver import Codec, _pad_np
from dc_vic_tpu_torch.models import build_comp_model, init_weights
from dc_vic_tpu_torch.models.convert import load_reference_state_dict
from dc_vic_tpu_torch.ops import rans_device as rd

MODELS = {"HyperpriorCharmVicModel": (True, False), "HyperpriorVicModel": (False, False)}
FORMATS = ("compressai", "compressai-portable", "tpu-host", "tpu-device", "tpu-portable")
H, W = 96, 80                      # pads to 128 x 128: y 8 x 8 x 24, z 2 x 2 x 16


def _images(seed, batch=2):
    return np.random.default_rng(seed).integers(0, 256, (batch, H, W, 3), dtype=np.uint8)


def _strings(res):
    return [r["string_list"] for r in res]


@pytest.fixture(scope="module", params=list(MODELS))
def models(request):
    """(port spec, JAX spec, JAX params) with the same weights: the port's
    seeded init carried into flax and back (strict)."""
    cfg = tiny_config(*MODELS[request.param])
    jspec = jax_build(cfg)
    seed = build_comp_model(cfg, device="cpu").module
    init_weights(seed, torch.Generator().manual_seed(0))
    params, _ = convert_state_dict({k: v.numpy() for k, v in seed.state_dict().items()},
                                   flax_template(jspec.module, cfg), strict=True)
    spec = build_comp_model(cfg, device="cpu")
    load_reference_state_dict(spec.module, export_state_dict(params))
    return spec, jspec, params


def _codec(spec, fmt):
    if fmt.startswith("compressai"):
        return Codec(spec, stream_format="compressai", portable=fmt.endswith("portable"))
    backend = "device" if fmt == "tpu-device" else "host"
    return Codec(spec, encode_backend=backend, lanes=8, portable=fmt.endswith("portable"))


@pytest.mark.parametrize("fmt", FORMATS)
def test_roundtrip_bit_exact(models, fmt):
    """The decoder's latents equal the encoder's bitwise, the decoded
    images are reconstruct_uint8 of the encoder's y_hat, and the header
    records the quality; a portable stream decodes alone too."""
    spec = models[0]
    codec = _codec(spec, fmt)
    img = _images(1)
    res = codec.compress(img, 2, debug=True)
    strings = _strings(res)
    assert codec.verify_roundtrip(res, strings, (H, W))
    out = codec.decompress(strings)
    y_hat = torch.from_numpy(np.ascontiguousarray(
        np.stack([r["y_hat"] for r in res]).transpose(0, 3, 1, 2)))
    with torch.no_grad():
        recon = spec.module.reconstruct_uint8(y_hat)
    np.testing.assert_array_equal(out, recon.permute(0, 2, 3, 1).numpy()[:, :H, :W])
    for r in res:
        header = HeaderHandler.decode(r["string_list"][0])
        assert header["quality_ind"] == 2 and header["portable"] == fmt.endswith("portable")
    if fmt.endswith("portable"):
        assert codec.verify_roundtrip(res[1:], strings[1:], (H, W))


def test_tpu_backends_write_identical_streams(models):
    spec = models[0]
    img = _images(2)
    host = _codec(spec, "tpu-host").compress(img, 0)
    device = _codec(spec, "tpu-device").compress(img, 0)
    assert _strings(host) == _strings(device)


def test_betas_are_ignored(models):
    """A model without beta conditioning writes the same streams at every
    quality and at any given betas; the header records what it was given."""
    spec = models[0]
    codec = _codec(spec, "tpu-host")
    img = _images(3, batch=1)
    at = [codec.compress(img, q)[0]["string_list"] for q in (0, 2)]
    given = codec.compress(img, beta_rate=0.3, beta_vq=2.9)[0]["string_list"]
    assert at[0][1:] == at[1][1:] == given[1:]
    assert HeaderHandler.decode(at[1][0])["quality_ind"] == 2
    assert HeaderHandler.decode(given[0])["quality_ind"] == 0
    np.testing.assert_array_equal(
        codec.decompress_raw([given[1]], [given[2]], (H, W), 0.0, 0.0),
        codec.decompress([at[1]]))


@pytest.fixture(scope="module")
def jcodec(models):
    """The JAX package's compressai-format Codec on the same weights."""
    _, jspec, params = models
    return JaxCodec(jspec, params, stream_format="compressai")


def test_compressai_streams_equal_the_jax_codec_s(models, jcodec):
    """The JAX package's Codec and the port's on the same weights and
    images write the same compressai bytes, and each decodes the other's
    streams to its own encoder's latents."""
    codec = Codec(models[0], stream_format="compressai")
    img = _images(4)
    jres = jcodec.compress(img, quality_ind=1, debug=True)
    res = codec.compress(img, 1, debug=True)
    assert _strings(jres) == _strings(res)
    assert codec.verify_roundtrip(res, _strings(jres), (H, W))
    assert jcodec.verify_roundtrip(jres, _strings(res), (H, W))


def test_encode_chain_integers_equal_jax(models, jcodec):
    """The y symbols and CDF indexes the encode chain derives from the same
    y and z symbols: the JAX Codec's chain (its shared executables) against
    the port's, whole planes, exact; y_hat within the model tests'
    tolerance."""
    spec, jspec, params = models
    codec = Codec(spec, stream_format="compressai")
    img = _pad_np(_images(5))
    y, z_sym = jspec.module.apply(params, jnp.asarray(img), None, None,
                                  method=jspec.module.encode_front)
    j_sym, j_idx, j_y_hat, _ = jcodec._encode_param_chain(y, z_sym)
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))
    with torch.no_grad():
        syms, idxs, y_hat, _ = codec._encode_param_chain(nchw(y), nchw(z_sym))
    assert len(syms) == codec.y_sections == (6 if spec.module.use_charm else 1)
    nhwc = lambda ts: torch.cat(ts, dim=1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(nhwc(syms), np.asarray(j_sym))
    np.testing.assert_array_equal(nhwc(idxs), np.asarray(j_idx))
    np.testing.assert_allclose(y_hat.permute(0, 2, 3, 1).numpy(), np.asarray(j_y_hat), **TOL)


def test_one_y_section_codes_as_the_jax_device_coder(models):
    """Without ChARM the y stream is one section of all yH * yW * Cy
    symbols (with ChARM six): the codec's own planes through the plain R1
    and R2 against the JAX device coder's encode_stream, pack_streams and
    decode_section, at lanes 8 (and 128 for the one section); symbols,
    cursors and lane states exact, every word consumed."""
    spec = models[0]
    codec = _codec(spec, "tpu-host")
    handle = codec.compress_dispatch(_images(6), 0)
    sym, idx = torch.cat(handle["out"]["syms"], dim=1), torch.cat(handle["out"]["idxs"], dim=1)
    B, C, yH, yW = sym.shape
    S = codec.y_sections
    sc = C // S
    assert codec._tpu_y_sections(C) == [(s * sc, (s + 1) * sc) for s in range(S)]
    table = codec._dtable("y")
    jtable = jrd.DeviceCdfTable(codec.y_table)
    for lanes in ((8, 128) if S == 1 else (8,)):
        packed, offsets, counts, esc, _ = rd.encode_pack(sym, idx, S, lanes, table)
        L = rd.section_lanes(sc * yH * yW, lanes)
        assert L == jrd.section_lanes(sc * yH * yW, lanes)
        secs = [(rd.to_stream(sym[:, s * sc:(s + 1) * sc], L).numpy().astype(np.int32),
                 rd.to_stream(idx[:, s * sc:(s + 1) * sc], L).numpy().astype(np.int32))
                for s in range(S)]
        vals, mask, jesc = jrd.encode_stream([(jnp.asarray(s), jnp.asarray(i))
                                              for s, i in secs], jtable, with_esc_counts=True)
        jpacked, jcounts = jrd.pack_streams(vals, mask)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        n = int(counts.sum())
        words = packed[:n]
        np.testing.assert_array_equal(words.numpy().view(np.uint16), np.asarray(jpacked)[:n])
        np.testing.assert_array_equal(esc.numpy(), np.asarray(jesc))
        base = (torch.cumsum(counts, 0) - counts).to(torch.int32)
        cur, state = torch.zeros(B, dtype=torch.int32), None
        jcur, jstate = jnp.zeros((B,), jnp.int32), None
        for s, (want_sym, sec_idx) in enumerate(secs):
            got, cur, state = rd.decode_section(
                words, base, cur, state, idx[:, s * sc:(s + 1) * sc].contiguous(),
                (B, sc, yH, yW), lanes, table, sparse_esc=True)
            jsym, jcur, jstate = jrd.decode_section(
                jnp.asarray(words.numpy().view(np.uint16)), jnp.asarray(base.numpy()), jcur,
                jstate, jnp.asarray(sec_idx), jtable, sparse_esc=True)
            np.testing.assert_array_equal(rd.to_stream(got, L).numpy(), np.asarray(jsym))
            np.testing.assert_array_equal(rd.to_stream(got, L).numpy(), want_sym)
            np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur))
            np.testing.assert_array_equal(state.numpy().view(np.uint32), np.asarray(jstate))
        np.testing.assert_array_equal(cur.numpy(), counts.numpy())


def test_entropy_chain_copy_without_a_context_model(models):
    """params_backend "cpu"'s EntropyChain copies the hyperdecoder and the
    z bottleneck, and the context model only where the model has one; a
    compressai Codec driven through the copy writes the model's own chain's
    strings and decodes them to the same latents and pixels."""
    from dc_vic_tpu_torch.models.dc_vic import EntropyChain
    spec = models[0]
    m = spec.module
    chain = EntropyChain(m)
    assert (chain.context_model is None) == (not m.use_charm)
    roots = {k.split(".")[0] for k in chain.state_dict()}
    assert roots == {"hyperdecoder", "entropy_model_z"} | ({"context_model"} if m.use_charm
                                                            else set())
    img = _images(7)
    plain = Codec(spec, stream_format="compressai")
    via_copy = Codec(spec, stream_format="compressai")
    via_copy._chain = chain
    res = plain.compress(img, 0, debug=True)
    strings = _strings(res)
    assert strings == _strings(via_copy.compress(img, 0))
    assert via_copy.verify_roundtrip(res, strings, (H, W))
    np.testing.assert_array_equal(via_copy.decompress(strings), plain.decompress(strings))


def test_bf16_deployment_numerics_round_trip(models):
    """codec_dtype bfloat16 with entropy_precision default: the conv stacks
    round to bf16 (no FiLM to leave out), the entropy chain stays f32, and
    the tpu format round-trips bit-exactly, portable streams included."""
    spec = models[0]
    cfg = tiny_config(spec.module.use_charm, spec.module.use_beta)
    cfg["codec_dtype"], cfg["entropy_precision"] = "bfloat16", "default"
    built = build_comp_model(cfg, device="cpu")
    built.module.load_state_dict(spec.module.state_dict())
    m = built.module
    assert m.encoder.conv1.weight.dtype == m.decoder.conv1.weight.dtype == torch.bfloat16
    assert m.hyperdecoder.hd_mu.conv3.weight.dtype == torch.float32
    for portable in (False, True):
        codec = Codec(built, encode_backend="device", lanes=8, portable=portable)
        img = _images(8)
        res = codec.compress(img, 0, debug=True)
        assert codec.verify_roundtrip(res, _strings(res), (H, W))
        assert codec.decompress(_strings(res)).shape == img.shape


def test_compress_cli_takes_the_checkpoint(models, tmp_path):
    """The compress CLI's body over a checkpoint of the model type: the
    released layout ('comp_model', 'module.' prefixes) loads strictly,
    selfcheck holds the decoder's latents to the encoder's, the files
    decode, and the streams are the model in memory's."""
    import json
    import yaml
    from dc_vic_tpu_torch.tools.compress import build_codec, compress_arrays
    spec = models[0]
    ckpt = tmp_path / "model.pth.tar"
    torch.save({"comp_model": {f"module.{k}": v for k, v in spec.module.state_dict().items()}},
               ckpt)
    cfg = tmp_path / "model.yaml"
    plain = json.loads(json.dumps(tiny_config(spec.module.use_charm, False)))
    cfg.write_text(yaml.safe_dump(plain))
    codec = build_codec(str(cfg), str(ckpt), device="cpu")
    img = _images(9, batch=1)[0]
    rows, decoded = compress_arrays(codec, [("a.png", img)], 1, str(tmp_path / "out"),
                                    selfcheck=True, decompress=True)
    assert decoded["a.png"].shape == img.shape and rows[0]["real_bpp"] > 0
    want = Codec(spec, portable=True).compress(img[None], 1)[0]["string_list"]
    assert (tmp_path / "out" / "a.bin").exists()
    assert codec.compress(img[None], 1)[0]["string_list"] == want
