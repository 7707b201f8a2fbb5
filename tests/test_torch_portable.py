"""Portable streams of the port's Codec on the CPU, case by case as
tests/test_portable.py holds the JAX Codec: ``Codec(portable=True)`` derives
every float that feeds symbolisation per image at the batch-1 shape on both
sides, so a stream decodes bit-exactly alone or in any grouping; a
non-portable stream records its encode batch and a mismatch fails fast.

Integers and latents: no tolerance. Pixels of one image decoded in two
groupings may differ by one step at a rounding tie (the reconstruction runs
batched, and another batch shape may sum in another order): <= 1, as the JAX
package's test allows.
"""
import numpy as np
import pytest
import torch

from test_torch_codec import spec  # noqa: F401 (fixture: the tiny model, JAX-round-tripped weights)
from train_helpers import flax_template

FORMATS = ["tpu-host", "tpu-device", "compressai"]


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_codec(spec, fmt: str, portable: bool):
    from dc_vic_tpu_torch.codec.driver import Codec
    if fmt == "compressai":
        return Codec(spec, stream_format="compressai", portable=portable)
    f, backend = fmt.split("-")
    return Codec(spec, stream_format=f, encode_backend=backend, lanes=8, portable=portable)


@pytest.fixture(scope="module", params=FORMATS)
def pcodec(request, spec):
    return make_codec(spec, request.param, portable=True)


def _images(n=4, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)


def _strings(res):
    return [r["string_list"] for r in res]


def test_portable_header_bit(pcodec):
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    res = pcodec.compress(_images(1), quality_ind=1)
    assert HeaderHandler.decode(res[0]["string_list"][0])["portable"] is True


def test_portable_header_equals_the_jax_header(pcodec):
    """The portable bit sits where the JAX package's header puts it."""
    from dc_vic_tpu.codec.container import HeaderHandler as JaxHeader
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    header = pcodec.compress(_images(2), quality_ind=1)[0]["string_list"][0]
    hdr = HeaderHandler.decode(header)
    if pcodec.stream_format == "tpu":
        want = JaxHeader.encode((64, 64), 0, 1, tpu_format=True, lanes=8, encode_batch=2,
                                esc_dense=hdr["esc_dense"], t2free=hdr["t2free"],
                                escfree=hdr["escfree"], portable=True, fast_entropy=False,
                                bf16=False)
    else:
        want = JaxHeader.encode((64, 64), hdr["max_sample"], 1, portable=True)
    assert header == want and JaxHeader.decode(header)["portable"] is True


def test_portable_batch4_decodes_individually_and_grouped(pcodec):
    """Encode a batch of 4, then decode it whole, each stream alone and a
    group of 3 the encoder never ran: the latents equal the encoder's
    bitwise in every grouping, in all three formats."""
    res = pcodec.compress(_images(4), quality_ind=0, debug=True)
    sls = _strings(res)
    assert pcodec.verify_roundtrip(res, sls, (64, 64))
    batched = pcodec.decompress(sls)
    for b in range(4):
        assert pcodec.verify_roundtrip([res[b]], [sls[b]], (64, 64)), \
            f"portable stream {b} failed the bit-exact batch-1 decode"
        one = pcodec.decompress([sls[b]])
        diff = np.abs(one[0].astype(np.int16) - batched[b].astype(np.int16))
        assert diff.max() <= 1
    assert pcodec.verify_roundtrip(res[1:4], sls[1:4], (64, 64))
    grp = pcodec.decompress(sls[1:4])
    assert np.abs(grp.astype(np.int16) - batched[1:4].astype(np.int16)).max() <= 1


def test_portable_decodes_on_fresh_codec(spec, pcodec):
    """Another Codec, built non-portable: the header's bit drives the decode
    path, and the stream decodes bit-exactly at batch 1."""
    res = pcodec.compress(_images(2, seed=3), quality_ind=1, debug=True)
    sls = _strings(res)
    fresh = make_codec(spec, "tpu-host" if pcodec.stream_format == "tpu" else "compressai",
                       portable=False)
    assert fresh.verify_roundtrip([res[0]], [sls[0]], (64, 64))
    assert fresh.decompress([sls[1]]).shape == (1, 64, 64, 3)


def test_portable_equals_nonportable_at_batch1(spec):
    """At batch 1 the per-image chain is the batch chain: the same payloads
    (the headers differ in the portable bit) and the same pixels."""
    imgs = _images(1, seed=5)
    a = make_codec(spec, "tpu-host", portable=True)
    b = make_codec(spec, "tpu-host", portable=False)
    ra, rb = a.compress(imgs, quality_ind=0), b.compress(imgs, quality_ind=0)
    assert ra[0]["string_list"][0] != rb[0]["string_list"][0]
    assert ra[0]["string_list"][1:] == rb[0]["string_list"][1:]
    np.testing.assert_array_equal(a.decompress(_strings(ra)), b.decompress(_strings(rb)))


def test_portable_backends_write_identical_streams(spec):
    """Host and device encode backends, portable: the same bytes."""
    imgs = _images(3, seed=9)
    host = make_codec(spec, "tpu-host", portable=True).compress(imgs, 0)
    device = make_codec(spec, "tpu-device", portable=True).compress(imgs, 0)
    assert _strings(host) == _strings(device)


def test_nonportable_batch_mismatch_fails_fast(spec):
    """Non-portable tpu streams record their encode batch; decoding at
    another batch raises."""
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    codec = make_codec(spec, "tpu-host", portable=False)
    sls = _strings(codec.compress(_images(2, seed=7), quality_ind=0))
    hdr = HeaderHandler.decode(sls[0][0])
    assert hdr["portable"] is False and hdr["encode_batch"] == 2
    assert codec.decompress(sls).shape == (2, 64, 64, 3)
    with pytest.raises(ValueError, match="encoded at batch 2"):
        codec.decompress([sls[0]])


@pytest.mark.parametrize("fmt", ["tpu-host", "compressai"])
def test_mixed_portable_and_nonportable_refused(spec, fmt):
    imgs = _images(1, seed=11)
    p = _strings(make_codec(spec, fmt, portable=True).compress(imgs, 0))
    n = _strings(make_codec(spec, fmt, portable=False).compress(imgs, 0))
    with pytest.raises(ValueError, match="mixed portable"):
        make_codec(spec, fmt, portable=False).decompress(p + n)


def test_portable_chain_runs_per_image_on_fresh_storage(spec, monkeypatch):
    """Every operand the portable chain hands to the model is a batch-1
    tensor at storage offset 0 with row-major strides (what a batch-1
    decoder would hold), on the encode and on the decode side; the
    non-portable chain hands over the batch."""
    codec = make_codec(spec, "tpu-device", portable=True)
    m = codec.module
    seen = []

    def spy(name):
        real = getattr(m, name)

        def wrapped(*args):
            for a in args:
                if isinstance(a, torch.Tensor) and a.numel():
                    seen.append((name, a.shape[0], a.storage_offset(), a.is_contiguous()))
            return real(*args)
        monkeypatch.setattr(m, name, wrapped)
    for name in ("hyper_decode", "charm_slice_params", "charm_symbolize", "charm_decode_step"):
        spy(name)
    res = codec.compress(_images(3, seed=13), 0)
    n_enc = len(seen)
    codec.decompress(_strings(res))
    assert n_enc and len(seen) > n_enc
    assert all(rec[1:] == (1, 0, True) for rec in seen), [r for r in seen if r[1:] != (1, 0, True)]
    assert sum(r[0] == "hyper_decode" for r in seen) == 3 + 3
    seen.clear()
    other = make_codec(spec, "tpu-device", portable=False)
    other.decompress(_strings(other.compress(_images(3, seed=13), 0)))
    assert {rec[1] for rec in seen} == {3}


def test_portable_decode_pipeline_never_waits_for_the_device(spec, monkeypatch):
    """The portable decode chain is more launches, not more waits: between
    the upload and the final fetch it calls no .cpu(), .item(), .tolist(),
    .numpy(), int(), float() or bool() of a tensor."""
    codec = make_codec(spec, "tpu-device", portable=True)
    strings = _strings(codec.compress(_images(3, seed=5), 0))
    pipeline = codec._decode_pipeline
    calls = []

    def guarded(*args, **kwargs):
        assert kwargs["portable"] is True
        with monkeypatch.context() as mp:
            for name in ("cpu", "item", "tolist", "numpy", "__int__", "__float__",
                         "__bool__", "__index__"):
                def trap(self, *a, _name=name, **k):
                    raise AssertionError(f"Tensor.{_name} inside the portable decode chain")
                mp.setattr(torch.Tensor, name, trap)
            out = pipeline(*args, **kwargs)
        calls.append(1)
        return out

    monkeypatch.setattr(codec, "_decode_pipeline", guarded)
    assert codec.decompress(strings).shape == (3, 64, 64, 3) and calls == [1]


def test_portable_bf16_default_streams_decode_in_any_grouping():
    """The deployment numerics with portable streams: bf16 stacks, the
    ``default`` entropy precision, tpu format, device backend."""
    from helpers import tiny_config
    from dc_vic_tpu_torch.codec.container import HeaderHandler
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import build_comp_model, init_weights
    built = build_comp_model(dict(tiny_config(), codec_dtype="bfloat16",
                                  entropy_precision="default"), device="cpu")
    init_weights(built.module, torch.Generator().manual_seed(0))
    codec = Codec(built, encode_backend="device", lanes=8, portable=True)
    res = codec.compress(_images(4, seed=17), 0, debug=True)
    sls = _strings(res)
    hdr = HeaderHandler.decode(sls[0][0])
    assert (hdr["portable"], hdr["bf16"], hdr["fast_entropy"]) == (True, True, True)
    fresh = Codec(built, lanes=8)
    for group in ([0, 1, 2, 3], [0, 1], [2, 3], [0], [3]):
        assert fresh.verify_roundtrip([res[b] for b in group], [sls[b] for b in group],
                                      (64, 64)), group


def test_portable_streams_cross_decode_with_the_jax_codec(spec):
    """The JAX package's ``Codec(portable=True)`` and the port's on the same
    weights and images (tpu format, host coder, batch 2): the same payload
    bytes after the header, and each decodes the other's streams to the
    latents its own encoder held, bitwise. Pixels of the two packages: one
    uint8 step apart at most, as tests/test_torch_model.py holds the
    reconstruction."""
    from dc_vic_tpu.codec.driver import Codec as JaxCodec
    from dc_vic_tpu.models import build_comp_model as jax_build
    from dc_vic_tpu.models.convert import convert_state_dict
    from helpers import tiny_config
    jspec = jax_build(tiny_config())
    template = flax_template(jspec.module, tiny_config())
    params, _ = convert_state_dict(
        {k: v.numpy() for k, v in spec.module.state_dict().items()}, template, strict=True)
    jcodec = JaxCodec(jspec, params, stream_format="tpu", encode_backend="host", lanes=8,
                      portable=True)
    pcodec = make_codec(spec, "tpu-host", portable=True)
    imgs = _images(2, seed=21)
    jres = jcodec.compress(imgs, quality_ind=0, debug=True)
    pres = pcodec.compress(imgs, quality_ind=0, debug=True)
    jsl, psl = _strings(jres), _strings(pres)
    assert jsl == psl
    # each side decodes the other's streams, alone and as the batch
    assert pcodec.verify_roundtrip(pres, jsl, (64, 64))
    assert jcodec.verify_roundtrip(jres, psl, (64, 64))
    assert pcodec.verify_roundtrip([pres[1]], [jsl[1]], (64, 64))
    diff = np.abs(pcodec.decompress(jsl).astype(np.int16)
                  - np.asarray(jcodec.decompress(psl)).astype(np.int16))
    assert diff.max() <= 1
