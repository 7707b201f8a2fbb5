"""The rest of the port's Codec surface on the tiny config on the CPU:
``params_backend`` and the entropy chain's CPU copy, the CPU chain's bits
against the thread count and the decode grouping, custom betas with
``decompress_raw``, the compressai format's predicted bits, and the shape
rules by which K1 and K2 take their kernels."""
import numpy as np
import pytest
import torch

from helpers import tiny_config
from train_helpers import flax_template


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
    load_reference_state_dict)."""
    from dc_vic_tpu.models import build_comp_model as jax_build
    from dc_vic_tpu.models.convert import convert_state_dict, export_state_dict
    from dc_vic_tpu_torch.models import build_comp_model, init_weights
    from dc_vic_tpu_torch.models.convert import load_reference_state_dict
    m = jax_build(tiny_config()).module
    template = flax_template(m, tiny_config())
    seed_model = build_comp_model(tiny_config(), device="cpu").module
    init_weights(seed_model, torch.Generator().manual_seed(0))
    params, _ = convert_state_dict(
        {k: v.numpy() for k, v in seed_model.state_dict().items()}, template, strict=True)
    out = build_comp_model(tiny_config(), device="cpu")
    load_reference_state_dict(out.module, export_state_dict(params))
    return out


def _images(seed, B=4, H=64, W=64):
    return np.random.default_rng(seed).integers(0, 256, (B, H, W, 3), dtype=np.uint8)


def test_params_backend_defaults_and_refusals(spec):
    """None is "cpu" for the compressai format and "accel" for the tpu
    format, as in the reference; "cpu" with the tpu format and unknown
    names raise. On a model that lies on the CPU the chain is the model's
    own."""
    from dc_vic_tpu_torch.codec.driver import Codec
    assert Codec(spec, stream_format="compressai").params_backend == "cpu"
    assert Codec(spec).params_backend == "accel"
    assert Codec(spec, stream_format="compressai", params_backend="accel").params_backend \
        == "accel"
    for kw in (dict(params_backend="cpu"), dict(stream_format="tpu", params_backend="cpu"),
               dict(stream_format="compressai", params_backend="gpu")):
        with pytest.raises(ValueError):
            Codec(spec, **kw)
    codec = Codec(spec, stream_format="compressai")
    assert codec._chain is spec.module and codec._chain_device.type == "cpu"


def test_entropy_chain_copy_holds_the_chain_s_modules_and_codes_alike(spec):
    """EntropyChain copies exactly the hyperdecoder, the context model and
    the z bottleneck, in f32, leaving the model's state dict as it was; a
    compressai Codec driven through the copy writes the strings of the
    model's own chain and decodes them to the same latents and pixels."""
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models.dc_vic import EntropyChain
    m = spec.module
    keys = set(m.state_dict())
    chain = EntropyChain(m)
    assert set(m.state_dict()) == keys
    own = {k: v for k, v in m.state_dict().items()
           if k.split(".")[0] in ("hyperdecoder", "context_model", "entropy_model_z")}
    copied = chain.state_dict()
    assert set(copied) == set(own)
    for k, v in copied.items():
        assert v.dtype == torch.float32 and torch.equal(v, own[k])
        assert v.data_ptr() != own[k].data_ptr()
    img = _images(1, B=2)
    plain = Codec(spec, stream_format="compressai")
    via_copy = Codec(spec, stream_format="compressai")
    via_copy._chain = chain
    res = plain.compress(img, 1, debug=True)
    res_copy = via_copy.compress(img, 1, debug=True)
    strings = [r["string_list"] for r in res]
    assert strings == [r["string_list"] for r in res_copy]
    assert via_copy.verify_roundtrip(res, strings, (64, 64))
    np.testing.assert_array_equal(via_copy.decompress(strings), plain.decompress(strings))


def test_tpu_streams_decode_on_the_model_s_chain_whatever_params_backend(spec):
    """The tpu format's entropy parameters are the model's own, derived on
    its device: a compressai Codec (whose chain would be a CPU copy on a
    card) reads tpu-format streams through the model's chain. Its chain is
    replaced here by a copy with other weights, which a tpu decode must not
    touch: the latents and pixels stay those of the tpu Codec."""
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models.dc_vic import EntropyChain
    tpu = Codec(spec, encode_backend="device")
    img = _images(5, B=2)
    res = tpu.compress(img, 2, debug=True)
    strings = [r["string_list"] for r in res]
    other = Codec(spec, stream_format="compressai")
    other._chain = EntropyChain(spec.module)
    with torch.no_grad():
        for p in other._chain.hyperdecoder.parameters():
            p.mul_(1.5)
    assert other.verify_roundtrip(res, strings, (64, 64))
    np.testing.assert_array_equal(other.decompress(strings), tpu.decompress(strings))


def test_cpu_chain_bits_hold_across_threads_and_groupings(spec):
    """The compressai format's chain on the CPU: a batch of four encoded at
    one thread and at four threads gives the same strings, and its
    non-portable streams decode to the encoder's latents as 4 and as 2 x 2
    at either thread count. Image by image they need not: the CPU's batch-1
    convolutions round otherwise (hyper_decode's output moves by about
    1e-7), so only portable streams decode alone, and they do."""
    from dc_vic_tpu_torch.codec.driver import Codec
    codec = Codec(spec, stream_format="compressai")
    img = _images(2)
    torch.set_num_threads(1)
    res = codec.compress(img, 0, debug=True)
    torch.set_num_threads(4)
    res4 = codec.compress(img, 0, debug=True)
    strings = [r["string_list"] for r in res]
    assert strings == [r["string_list"] for r in res4]
    for threads in (4, 1):
        torch.set_num_threads(threads)
        for lo, size in ((0, 4), (0, 2), (2, 2)):
            assert codec.verify_roundtrip(res[lo:lo + size], strings[lo:lo + size], (64, 64))
    portable = Codec(spec, stream_format="compressai", portable=True)
    res = portable.compress(img, 0, debug=True)
    for b, r in enumerate(res):
        assert portable.verify_roundtrip([r], [r["string_list"]], (64, 64)), b


@pytest.mark.parametrize("fmt", ["tpu", "compressai"])
def test_custom_betas_and_decompress_raw(spec, fmt):
    """Betas given without a quality write that quality's z and y strings
    with quality 0 in the header; decompress_raw with those betas gives
    that quality's pixels. Neither a quality nor both betas raises."""
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    from dc_vic_tpu_torch.codec.driver import Codec
    codec = (Codec(spec, lanes=8) if fmt == "tpu"
             else Codec(spec, stream_format="compressai"))
    img = _images(3, B=2, H=96, W=80)
    br, bv = spec.quality_betas(1)
    by_quality = codec.compress(img, 1)
    by_betas = codec.compress(img, beta_rate=br, beta_vq=bv)
    for q, b in zip(by_quality, by_betas):
        assert q["string_list"][1:] == b["string_list"][1:]
        hq, hb = (HeaderHandler.decode(r["string_list"][0]) for r in (q, b))
        assert (hq["quality_ind"], hb["quality_ind"]) == (1, 0)
        assert {k: v for k, v in hq.items() if k != "quality_ind"} == \
            {k: v for k, v in hb.items() if k != "quality_ind"}
    headers = [HeaderHandler.decode(r["string_list"][0]) for r in by_betas]
    flags = dict(lanes=headers[0]["lanes"], esc_dense=any(h["esc_dense"] for h in headers),
                 t2free=all(h["t2free"] for h in headers),
                 escfree=all(h["escfree"] for h in headers)) if fmt == "tpu" else {}
    raw = codec.decompress_raw([r["string_list"][1] for r in by_betas],
                               [r["string_list"][2] for r in by_betas], (96, 80), br, bv,
                               stream_format=fmt, **flags)
    np.testing.assert_array_equal(raw, codec.decompress([r["string_list"]
                                                         for r in by_quality]))
    for kw in (dict(), dict(beta_rate=br), dict(beta_vq=bv)):
        with pytest.raises(ValueError):
            codec.compress(img, **kw)


def test_compressai_predicted_bits_are_the_table_cost(spec):
    """pred_y_bpp and pred_z_bpp of the compressai format are
    rans_device.coded_bits of the symbols the host coder codes, over the
    image's pixels, as in the tpu format's host backend."""
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.ops import rans_device as rd
    codec = Codec(spec, stream_format="compressai")
    img = _images(4, B=2, H=96, W=80)
    handle = codec.compress_dispatch(img, 1)
    out = handle["out"]
    res = codec.compress_finalize(handle)
    y_bits = rd.coded_bits(torch.cat(out["syms"], 1), torch.cat(out["idxs"], 1),
                           rd.DeviceCdfTable(codec.y_table, "cpu"))
    z = out["z_sym"]
    z_bits = rd.coded_bits(z, rd.channel_rows(*z.shape, "cpu"),
                           rd.DeviceCdfTable(codec.z_table, "cpu"))
    for b, r in enumerate(res):
        assert r["pred_y_bpp"] == float(y_bits[b]) / (96 * 80) > 0
        assert r["pred_z_bpp"] == float(z_bits[b]) / (96 * 80) > 0


@pytest.mark.parametrize("shape,dtype,want", [
    ((2, 4096, 512), torch.float32, True), ((1, 1037, 128), torch.float32, True),
    ((16, 4096, 384), torch.float32, True), ((1, 64, 64), torch.float32, False),
    ((1, 64, 516), torch.float32, False), ((1, 64, 640), torch.float32, False),
    ((1, 64, 256), torch.bfloat16, False), ((64, 256), torch.float32, False)])
def test_attention_kernel_rule(shape, dtype, want):
    """K2 takes float32 [B, N, C] with C in 128, 256, 384, 512 and any N;
    on the CPU every shape takes the plain version."""
    from dc_vic_tpu_torch.ops import attention
    assert attention.use_kernel(shape, dtype) is want
    if len(shape) == 3:
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(1, 16, shape[-1], generator=g).to(dtype) for _ in range(3))
        before = attention.launches
        assert torch.equal(attention.flash_attention(q, k, v), attention.attention_plain(q, k, v))
        assert attention.launches == before


@pytest.mark.parametrize("D,N,dtype,want", [
    (4, 256, torch.float32, True), (4, 11622, torch.float32, True),
    (4, 11623, torch.float32, False), (8, 256, torch.float32, False),
    (3, 256, torch.float32, False), (4, 256, torch.bfloat16, False)])
def test_vq_kernel_rule(D, N, dtype, want):
    """K1 takes float32 rows of 4 components against a codebook whose 20
    bytes per entry fit the 227 KiB of shared memory; on the CPU every
    shape takes the plain version."""
    from dc_vic_tpu_torch.ops import vq
    assert vq.use_kernel(D, N, dtype) is want
    g = torch.Generator().manual_seed(1)
    z, cb = torch.randn(50, D, generator=g), torch.randn(min(N, 300), D, generator=g)
    before = vq.launches
    assert torch.equal(vq.vq_argmin(z, cb), vq.vq_argmin_plain(z, cb))
    assert vq.launches == before
