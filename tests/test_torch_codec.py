"""The port's own Codec on the tiny config on the CPU, in both stream
formats: compress -> bitstream -> decompress, bit-exact y_hat, the tpu
format's header and fail-fast checks, and the port's import boundary."""
import ast
import os

import numpy as np
import pytest
import torch

from helpers import tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spec():
    """The tiny model with seeded weights that went through the JAX
    package's parameter tree and back (export_state_dict ->
    load_reference_state_dict): the coder adds no parameter, so the strict
    load needs nothing new."""
    import jax
    import jax.numpy as jnp
    from dc_vic_tpu.models import build_comp_model as jax_build
    from dc_vic_tpu.models.convert import convert_state_dict, export_state_dict
    from dc_vic_tpu_torch.models import build_comp_model, init_weights
    from dc_vic_tpu_torch.models.convert import load_reference_state_dict
    m = jax_build(tiny_config()).module
    x0, b = jnp.zeros((1, 64, 64, 3)), jnp.array([1.0])
    template = jax.eval_shape(
        lambda r: m.init({"params": r}, x0, b, b, is_train=False), jax.random.PRNGKey(0))
    seed_model = build_comp_model(tiny_config(), device="cpu").module
    init_weights(seed_model, torch.Generator().manual_seed(0))
    params, _ = convert_state_dict(
        {k: v.numpy() for k, v in seed_model.state_dict().items()}, template, strict=True)
    out = build_comp_model(tiny_config(), device="cpu")
    load_reference_state_dict(out.module, export_state_dict(params))
    return out


@pytest.fixture(scope="module")
def codec(spec):
    from dc_vic_tpu_torch.codec.driver import Codec
    return Codec(spec, stream_format="compressai")


@pytest.fixture(scope="module")
def tpu_codecs(spec):
    """(host backend, device backend) codecs of the tpu format; lanes 8 so
    that the tiny sections really interleave."""
    from dc_vic_tpu_torch.codec.driver import Codec
    return (Codec(spec, lanes=8), Codec(spec, encode_backend="device", lanes=8))


@pytest.mark.parametrize("batch,H,W", [(2, 96, 80), (1, 96, 80), (1, 64, 64)])
def test_roundtrip_bit_exact(codec, batch, H, W):
    """96x80 is reflect-padded to 128x128; at 64x64 z is 1x1, whose tensors
    read as channels-last once permuted (the layout trap the entropy chain
    guards against). The decoder's y_hat and z_hat equal the encoder's
    bitwise, and the decoded images are reconstruct_uint8 of the encoder's
    y_hat."""
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    img = np.random.default_rng(batch + H).integers(0, 256, (batch, H, W, 3),
                                                     dtype=np.uint8)
    res = codec.compress(img, 1, debug=True)
    strings = [r["string_list"] for r in res]
    assert len(res) == batch
    for r in res:
        header = HeaderHandler.decode(r["string_list"][0])
        assert len(r["string_list"][0]) == 6
        assert header["img_size"] == (H, W) and header["quality_ind"] == 1
        assert header["stream_format"] == "compressai"
        assert header["max_sample"] == min(255, int(np.abs(
            np.stack([q["y_hat"] for q in res])).max()))
        assert r["bpp"] == 8 * sum(4 + len(s) for s in r["string_list"]) / (H * W)
    assert codec.verify_roundtrip(res, strings, (H, W))
    out = codec.decompress(strings)
    assert out.shape == (batch, H, W, 3) and out.dtype == np.uint8

    b1, b2 = codec._betas(1)
    y_hat = torch.from_numpy(np.ascontiguousarray(
        np.stack([r["y_hat"] for r in res]).transpose(0, 3, 1, 2)))
    with torch.no_grad():
        recon = codec.module.reconstruct_uint8(y_hat, b1, b2)
    np.testing.assert_array_equal(out, recon.permute(0, 2, 3, 1).numpy()[:, :H, :W])


def test_corrupt_roundtrip_is_detected(codec):
    """verify_roundtrip compares real latents: a y stream from another image
    fails it."""
    rng = np.random.default_rng(7)
    a = codec.compress(rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8), 0, debug=True)
    b = codec.compress(rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8), 0, debug=True)
    swapped = [[a[0]["string_list"][0], a[0]["string_list"][1], b[0]["string_list"][2]]]
    assert codec.verify_roundtrip(a, [a[0]["string_list"]], (64, 64))
    assert not codec.verify_roundtrip(a, swapped, (64, 64))


def test_decompress_rejects_portable_streams(codec):
    """What is left to reject now that portable streams decode: a portable
    and a non-portable stream in one decode batch, in both formats."""
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    for tpu in (True, False):
        headers = [HeaderHandler.encode((64, 64), 0, 0, tpu_format=tpu, encode_batch=2,
                                        portable=p) for p in (True, False)]
        with pytest.raises(ValueError, match="portable"):
            codec.decompress([[h, b"", b""] for h in headers])


def test_codec_defaults_are_the_reference_s(spec):
    import inspect
    from dc_vic_tpu_torch.codec.driver import Codec
    params = inspect.signature(Codec.__init__).parameters
    assert (params["stream_format"].default, params["encode_backend"].default,
            params["lanes"].default) == ("tpu", "host", 128)
    for bad in (dict(stream_format="zip"), dict(encode_backend="gpu"), dict(lanes=96),
                dict(lanes=8192)):
        with pytest.raises(ValueError):
            Codec(spec, **bad)
    before = set(spec.module.state_dict())
    Codec(spec, encode_backend="device")._dtable("y")
    assert set(spec.module.state_dict()) == before      # the coder has no parameters


@pytest.mark.parametrize("batch,H,W", [(2, 96, 80), (1, 96, 80), (1, 64, 64)])
def test_tpu_roundtrip_bit_exact_and_backends_agree(tpu_codecs, batch, H, W):
    """tpu format: host and device backends write identical strings; the
    decoder's latents equal the encoder's bitwise; the decoded image is
    reconstruct_uint8 of the encoder's y_hat; the header carries what the
    reference's carries."""
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    host, device = tpu_codecs
    img = np.random.default_rng(batch + H).integers(0, 256, (batch, H, W, 3), dtype=np.uint8)
    res = device.compress(img, 1, debug=True)
    res_host = host.compress(img, 1, debug=True)
    strings = [r["string_list"] for r in res]
    assert strings == [r["string_list"] for r in res_host]
    for r, rh in zip(res, res_host):
        hdr = HeaderHandler.decode(r["string_list"][0])
        assert len(r["string_list"][0]) == 9
        assert hdr["stream_format"] == "tpu" and hdr["lanes"] == 8
        assert hdr["encode_batch"] == batch and hdr["quality_ind"] == 1
        assert (hdr["portable"], hdr["fast_entropy"], hdr["bf16"]) == (False, False, False)
        assert hdr["t2free"] is True and hdr["esc_dense"] is False
        assert r["bpp"] == 8 * sum(4 + len(s) for s in r["string_list"]) / (H * W)
        assert r["pred_y_bpp"] == 8 * len(r["string_list"][2]) / (H * W)
        assert r["pred_z_bpp"] == 8 * len(r["string_list"][1]) / (H * W)
        # the host backend reports the table cost without the flush
        flush = 8 * 4 * 8 / (H * W)
        assert 0 <= r["pred_y_bpp"] - rh["pred_y_bpp"] <= flush + 32 / (H * W)
        np.testing.assert_array_equal(r["y_hat"], rh["y_hat"])
    for codec in tpu_codecs:
        assert codec.verify_roundtrip(res, strings, (H, W))
    out = host.decompress(strings)
    assert out.shape == (batch, H, W, 3) and out.dtype == np.uint8
    pending = device.decompress(strings, defer_fetch=True)
    np.testing.assert_array_equal(pending.fetch(), out)
    b1, b2 = host._betas(1)
    y_hat = torch.from_numpy(np.ascontiguousarray(
        np.stack([r["y_hat"] for r in res]).transpose(0, 3, 1, 2)))
    with torch.no_grad():
        recon = host.module.reconstruct_uint8(y_hat, b1, b2)
    np.testing.assert_array_equal(out, recon.permute(0, 2, 3, 1).numpy()[:, :H, :W])


def test_tpu_streams_and_headers_equal_the_reference_coder_s(tpu_codecs):
    """The symbols the port's encoder chain produced, coded by the JAX
    package's host coder and headed by its HeaderHandler with the flags its
    codec derives (escfree per image, esc_dense against esc_cap, t2free):
    the same bytes as the port's result, for both backends. The tiny
    model's symbols reach past its narrow CDF rows, so the streams hold
    escapes."""
    from dc_vic_tpu.codec.container import HeaderHandler as JaxHeader
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    from dc_vic_tpu.ops.rans import CdfTable as JaxTable, tpu_encode_sections as jax_encode
    from dc_vic_tpu.ops.rans_device import esc_cap, section_lanes
    host, device = tpu_codecs
    img = np.random.default_rng(3).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    img[1, :32] = 255                                    # a flat half: other statistics
    handle = host.compress_dispatch(img, 0)
    res = host.compress_finalize(handle)
    assert [r["string_list"] for r in device.compress(img, 0)] == \
        [r["string_list"] for r in res]
    out = handle["out"]
    B, S = 2, host.num_slices
    assert not any(HeaderHandler.decode(r["string_list"][0])["escfree"] for r in res)

    def stream_order(t):
        return t.permute(0, 2, 3, 1).reshape(B, -1).to(torch.int32).numpy()
    tables = {k: JaxTable(t.cdfs, t.cdf_lengths, t.offsets)
              for k, t in (("y", host.y_table), ("z", host.z_table))}
    z = stream_order(out["z_sym"])
    Cz = host.bottleneck_z
    z_idx = np.broadcast_to(np.arange(Cz, dtype=np.int32), (z.shape[1] // Cz, Cz)).reshape(-1)
    ys = [stream_order(t) for t in out["syms"]]
    yi = [stream_order(t) for t in out["idxs"]]
    Lz, Ly = section_lanes(z.shape[1], 8), section_lanes(ys[0].shape[1], 8)
    coded = []
    for b in range(B):
        z_str, z_esc, z_t2 = jax_encode([(z[b].reshape(-1, Lz), z_idx.reshape(-1, Lz))],
                                        tables["z"], True)
        y_str, y_esc, y_t2 = jax_encode([(ys[s][b].reshape(-1, Ly), yi[s][b].reshape(-1, Ly))
                                         for s in range(S)], tables["y"], True)
        coded.append((z_str, y_str, z_esc, y_esc, z_t2 or y_t2))
    t2free = not any(c[4] for c in coded)
    for b, (z_str, y_str, z_esc, y_esc, _) in enumerate(coded):
        header = JaxHeader.encode(
            (64, 64), 0, 0, tpu_format=True, lanes=8,
            esc_dense=bool(y_esc > esc_cap(ys[0].shape[1]) or z_esc > esc_cap(z.shape[1])),
            t2free=t2free, escfree=(y_esc == 0 and z_esc == 0), portable=False,
            encode_batch=B, fast_entropy=False, bf16=False)
        assert res[b]["string_list"] == [header, z_str, y_str]


def test_tpu_decoder_fails_fast(tpu_codecs):
    """A batch-2 stream decoded as batch 1, a header that asks for bf16 or
    the fast entropy chain, a truncated stream, a flipped byte and a stream
    too long for the geometry all raise."""
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    host, _ = tpu_codecs
    img = np.random.default_rng(11).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    strings = [r["string_list"] for r in host.compress(img, 0)]
    host.decompress(strings)
    with pytest.raises(ValueError, match="batch 2"):
        host.decompress(strings[:1])
    for kw in (dict(bf16=True), dict(fast_entropy=True)):
        header = HeaderHandler.encode((64, 64), 0, 0, tpu_format=True, lanes=8,
                                      encode_batch=2, **kw)
        with pytest.raises(ValueError, match="other setting"):
            host.decompress([[header, s[1], s[2]] for s in strings])
    y0 = strings[0][2]
    flipped = bytes([y0[40] ^ 0x5A]) .join([y0[:40], y0[41:]])
    for bad in (y0[:len(y0) // 2], flipped, y0 + b"\0\0"):
        with pytest.raises(RuntimeError, match="integrity|poison"):
            host.decompress([[strings[0][0], strings[0][1], bad], strings[1]])
    with pytest.raises(ValueError, match="capacity"):
        host.decompress([[strings[0][0], strings[0][1], y0 * 200], strings[1]])
    mixed = [strings[0], [HeaderHandler.encode((64, 64), 0, 0), b"", b""]]
    with pytest.raises(ValueError, match="share"):
        host.decompress(mixed)


def test_decode_pipeline_never_waits_for_the_device(tpu_codecs, monkeypatch):
    """Between the upload of the word buffers and the final fetch the decode
    chain calls nothing that would synchronise with a card: no .cpu(),
    .item(), .tolist(), .numpy(), no int(), float() or bool() of a tensor."""
    host, _ = tpu_codecs
    img = np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    strings = [r["string_list"] for r in host.compress(img, 0)]
    pipeline = host._decode_pipeline
    calls = []

    def guarded(*args, **kwargs):
        with monkeypatch.context() as m:
            for name in ("cpu", "item", "tolist", "numpy", "__int__", "__float__",
                         "__bool__", "__index__"):
                def trap(self, *a, _name=name, **k):
                    raise AssertionError(f"Tensor.{_name} inside the decode chain")
                m.setattr(torch.Tensor, name, trap)
            m.setattr(torch.cuda, "synchronize", lambda *a, **k: (_ for _ in ()).throw(
                AssertionError("torch.cuda.synchronize inside the decode chain")))
            out = pipeline(*args, **kwargs)
        calls.append(1)
        return out

    monkeypatch.setattr(host, "_decode_pipeline", guarded)
    want = host.decompress(strings)
    assert calls == [1] and want.shape == (2, 64, 64, 3)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax, flax or
    the JAX package: the machine with the card has none of them."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "dc_vic_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "dc_vic_tpu"), (path, mod)
