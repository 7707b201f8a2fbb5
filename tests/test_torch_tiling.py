"""The port's tiling of images over 1024 px against the JAX package's: the
tiling helpers, the model's split-path methods on the same weights, the
codec's tiled VQGAN encode and tiled reconstruction against tile-by-tile
calls stitched on the host, and tiled round trips in both stream formats.

Floats agree within atol = rtol = 1e-3 (XLA:CPU against oneDNN summation
order, as in tests/test_torch_model.py); integers are equal except VQ
indices whose top-two distances are within 1e-5 and z symbols whose
pre-round value lies within 1e-4 of a rounding boundary (at most 0.1% of
either)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from helpers import tiny_config
from train_helpers import flax_template

TOL = dict(atol=1e-3, rtol=1e-3)
BETAS = (2.29, 3.0)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """(the JAX module, its params, the port's spec): the tiny model with
    seeded weights that went through the JAX package's parameter tree and
    back (export_state_dict -> load_reference_state_dict)."""
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
    return m, params, out


@pytest.fixture(scope="module")
def spec(models):
    return models[2]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape,window,stride", [
    ((2, 160, 288, 5), 64, 32), ((1, 1088, 128, 3), 512, 256), ((1, 2048, 1408, 1), 512, 256),
    ((2, 68, 8, 4), 32, 16), ((1, 128, 88, 2), 32, 16), ((3, 40, 24, 1), 8, 4),
    ((1, 512, 512, 1), 512, 256), ((1, 1100, 1536, 1), 512, 256)])
def test_tiling_helpers_match_jax(shape, window, stride):
    """tile_starts, keep_region, extract_tiles and stitch_tiles of the
    port's copy give the JAX package's integers and arrays; stitching the
    tiles back gives the input."""
    from dc_vic_tpu.codec import tiling as ref
    from dc_vic_tpu_torch.codec import tiling
    x = np.random.default_rng(shape[1]).integers(0, 255, shape).astype(np.uint8)
    for full in shape[1:3]:
        starts = tiling.tile_starts(full, window, stride)
        assert starts == ref.tile_starts(full, window, stride)
        for i in range(len(starts)):
            assert (tiling.keep_region(starts, i, window, stride, full)
                    == ref.keep_region(starts, i, window, stride, full))
    tiles, tops, lefts = tiling.extract_tiles(x, window, stride)
    want, w_tops, w_lefts = ref.extract_tiles(x, window, stride)
    np.testing.assert_array_equal(tiles, want)
    assert (tops, lefts) == (w_tops, w_lefts)
    out = tiling.stitch_tiles(tiles, x.shape, tops, lefts, window, stride)
    np.testing.assert_array_equal(out, ref.stitch_tiles(want, x.shape, tops, lefts, window,
                                                        stride))
    np.testing.assert_array_equal(out, x)


def test_split_path_model_methods_match_jax(models):
    """vq_encode_tile on a uint8 tile, vq_quantize of the JAX latent and
    encode_front_from_vq from the JAX latent and indices, in f32, against
    the JAX methods on the same weights (tolerances in the module
    docstring)."""
    import jax
    import jax.numpy as jnp
    m, params, spec = models
    port = spec.module
    tile = np.random.default_rng(3).integers(0, 256, (1, 64, 96, 3), dtype=np.uint8)
    b1, b2 = jnp.array([BETAS[0]]), jnp.array([BETAS[1]])

    def run(method, *args):  # one compiled graph: cheaper than eager here
        out = jax.jit(lambda p, *a: m.apply(p, *a, method=method))(params, *args)
        return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)
    h_j = run(m.vq_encode_tile, jnp.asarray(tile))
    lat_j, idx_j = run(m.vq_quantize, jnp.asarray(h_j))
    y_j, z_j = run(m.encode_front_from_vq, jnp.asarray(tile), jnp.asarray(lat_j),
                   jnp.asarray(idx_j), b1, b2)
    with torch.no_grad():
        h = port.vq_encode_tile(_nchw(tile))
        lat, idx = port.vq_quantize(_nchw(h_j).contiguous())
        y, z = port.encode_front_from_vq(_nchw(tile), _nchw(lat_j).contiguous(),
                                         torch.from_numpy(idx_j), torch.tensor([BETAS[0]]),
                                         torch.tensor([BETAS[1]]))
    assert h.dtype == torch.float32 and y.dtype == torch.float32 and z.dtype == torch.int16
    np.testing.assert_allclose(_nhwc(h), h_j, **TOL)
    cb = port.vq_model.quantize.embedding.weight.detach()
    d = ((cb * cb).sum(-1)[None] - 2 * torch.from_numpy(h_j.reshape(-1, 4)) @ cb.t()).numpy()
    top2 = np.sort(d, axis=1)[:, :2]
    bad = (idx.numpy() != idx_j).reshape(-1)
    assert np.all(top2[bad, 1] - top2[bad, 0] < 1e-5) and bad.sum() <= 1e-3 * bad.size
    np.testing.assert_allclose(_nhwc(lat), lat_j, **TOL)
    np.testing.assert_allclose(_nhwc(y), y_j, **TOL)
    with torch.no_grad():
        pre = _nhwc(port.hyperencoder(y).float() - port.entropy_model_z.medians().view(
            1, -1, 1, 1))
    bad = _nhwc(z) != z_j
    frac = np.abs(np.abs(pre - np.floor(pre)) - 0.5)
    assert np.all(frac[bad] < 1e-4) and bad.sum() <= 1e-3 * bad.size
    # encode_front is the whole-image path through the same tail
    from dc_vic_tpu_torch.models.dc_vic import to_model_range
    x = _nchw(tile)
    with torch.no_grad():
        got = port.encode_front(x, torch.tensor([BETAS[0]]), torch.tensor([BETAS[1]]))
        want = port.encode_front_from_vq(x, *port.vq_encode(to_model_range(x)),
                                         torch.tensor([BETAS[0]]), torch.tensor([BETAS[1]]))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _chunked(tiles, fn, chunk=16):
    """fn over the tiles [T*B, ...] in chunks of ``chunk``, the last one
    filled up with the first tile, as the codec batches them."""
    pad = (-tiles.shape[0]) % chunk
    full = np.concatenate([tiles] + [tiles[:1]] * pad)
    return np.concatenate([fn(full[k:k + chunk]) for k in range(0, len(full), chunk)])[
        :tiles.shape[0]]


def test_split_paths_equal_host_stitched_tiles(spec):
    """_split_vq_encode and _split_reconstruct of a 1088x64 image equal the
    tiles cut by extract_tiles, run through vq_encode_tile /
    reconstruct_uint8 in the same chunks of 16, stitched on the host by
    stitch_tiles (and quantized once): bitwise. The VQGAN encode of a tile
    alone gives the same bits as in its chunk."""
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.codec.tiling import extract_tiles, stitch_tiles
    codec = Codec(spec, stream_format="compressai")
    m = spec.module
    x = np.random.default_rng(0).integers(0, 256, (1, 1088, 64, 3), dtype=np.uint8)
    with torch.no_grad():
        lat, idx = codec._split_vq_encode(torch.from_numpy(x))
        tiles, tops, lefts = extract_tiles(x, 512, 256)
        assert tiles.shape[0] == 4
        enc = lambda t: _nhwc(m.vq_encode_tile(_nchw(t)))
        h = stitch_tiles(_chunked(tiles, enc), (1, 136, 8, 4), [t // 8 for t in tops],
                         [l // 8 for l in lefts], 64, 32)
        want_lat, want_idx = m.vq_quantize(_nchw(h).contiguous())
        assert torch.equal(lat, want_lat) and torch.equal(idx, want_idx)
        alone = stitch_tiles(np.concatenate([enc(t[None]) for t in tiles]), (1, 136, 8, 4),
                             [t // 8 for t in tops], [l // 8 for l in lefts], 64, 32)
        np.testing.assert_array_equal(alone, h)

        y = torch.randn(1, 24, 68, 4, generator=torch.Generator().manual_seed(1)) * 3
        b1, b2 = codec._betas(0)
        img = codec._split_reconstruct(y, b1, b2)
        assert img.shape == (1, 3, 1088, 64) and img.dtype == torch.uint8
        ytiles, tops, lefts = extract_tiles(_nhwc(y), 32, 16)
        assert ytiles.shape[0] == 4
        rec = lambda t: _nhwc(m.reconstruct_uint8(_nchw(t).contiguous(), b1, b2))
        want = stitch_tiles(_chunked(ytiles, rec), (1, 1088, 64, 3), tops, lefts, 32, 16,
                            scale=16)
    np.testing.assert_array_equal(_nhwc(img), want)


def _tile_marked(x, f):
    """A stand-in for a tile's network, exact in float64: each channel of x
    pooled (f > 0) or repeated (f < 0) by |f|, plus one channel holding
    the tile's own mean, so that a value taken from the wrong tile, image
    or offset differs."""
    x = x.to(torch.float64)
    body = F.avg_pool2d(x, f) if f > 0 else x.repeat_interleave(-f, 2).repeat_interleave(-f, 3)
    mean = x.mean(dim=(1, 2, 3), keepdim=True).expand(-1, 1, *body.shape[2:])
    return torch.cat([body, mean], dim=1)


def test_split_paths_place_the_tiles_of_a_batch(spec):
    """Two 1088x832 images (4 x 3 tiles each, middle tiles on both axes, 24
    tiles in two chunks, the last one filled up): the codec's
    position-major [T*B] tile order and its overlap-discard stitch, held
    against extract_tiles / stitch_tiles, the JAX package's helpers
    (byte-equal copies). The tile networks are replaced by _tile_marked,
    so every tile, image and keep region is told apart at no cost."""
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.codec.tiling import extract_tiles, stitch_tiles
    codec = Codec(spec, stream_format="compressai")
    m = spec.module
    B, H, W = 2, 1088, 832
    x = np.random.default_rng(4).integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    y = np.random.default_rng(5).integers(0, 256, (B, H // 16, W // 16, 3)).astype(np.float32)
    m.vq_encode_tile = lambda t: _tile_marked(t, 8).float()
    m.reconstruct_uint8 = lambda t, b1, b2: _tile_marked(t, -16)[:, 1:].to(torch.uint8)
    try:
        with torch.no_grad():
            lat, idx = codec._split_vq_encode(torch.from_numpy(x))
            img = codec._split_reconstruct(_nchw(y).contiguous(), None, None)
        tiles, tops, lefts = extract_tiles(x, 512, 256)
        assert tiles.shape[0] == 12 * B
        h = stitch_tiles(_nhwc(m.vq_encode_tile(_nchw(tiles))), (B, H // 8, W // 8, 4),
                         [t // 8 for t in tops], [l // 8 for l in lefts], 64, 32)
        ytiles, tops, lefts = extract_tiles(y, 32, 16)
        assert ytiles.shape[0] == 12 * B
        want = stitch_tiles(_nhwc(m.reconstruct_uint8(_nchw(ytiles), None, None)),
                            (B, H, W, 3), tops, lefts, 32, 16, scale=16)
    finally:
        del m.vq_encode_tile, m.reconstruct_uint8
    with torch.no_grad():
        want_lat, want_idx = m.vq_quantize(_nchw(h).contiguous())
    assert torch.equal(lat, want_lat) and torch.equal(idx, want_idx)
    assert img.shape == (B, 3, H, W)
    np.testing.assert_array_equal(_nhwc(img), want)


@pytest.mark.parametrize("fmt", ["tpu", "compressai"])
def test_large_image_round_trips_through_the_tiled_paths(spec, fmt):
    """A 1088x128 image (larger side over 1024 px) takes the tiled encode
    and the tiled reconstruction: the decoder's latents equal the encoder's
    bitwise, and the decoded image is _split_reconstruct of the encoder's
    y_hat, cropped."""
    from dc_vic_tpu_torch.codec.driver import Codec
    codec = (Codec(spec, encode_backend="device") if fmt == "tpu"
             else Codec(spec, stream_format="compressai"))
    calls = []
    for name in ("_split_vq_encode", "_split_reconstruct"):
        fn = getattr(codec, name)

        def spy(*args, _fn=fn, _name=name):
            out = _fn(*args)
            calls.append((_name, args[0], out))
            return out
        setattr(codec, name, spy)
    img = np.random.default_rng(2).integers(0, 256, (1, 1088, 128, 3), dtype=np.uint8)
    res = codec.compress(img, 1, debug=True)
    strings = [r["string_list"] for r in res]
    assert codec.verify_roundtrip(res, strings, (1088, 128))
    out = codec.decompress(strings)
    assert [c[0] for c in calls] == ["_split_vq_encode", "_split_reconstruct"]
    _, y_hat, img_out = calls[1]
    np.testing.assert_array_equal(_nhwc(y_hat), np.stack([r["y_hat"] for r in res]))
    assert out.shape == (1, 1088, 128, 3) and img_out.shape == (1, 3, 1088, 128)
    np.testing.assert_array_equal(out, _nhwc(img_out))


@pytest.mark.parametrize("side,tiled", [(1024, False), (1025, True), (1088, True)])
def test_split_threshold(spec, side, tiled):
    """The encode tiles when the padded image's larger side exceeds 1024,
    the reconstruction when the image's does: the same images, because 1024
    is a multiple of the pad stride. A 1024 px side stays whole."""
    from dc_vic_tpu_torch.codec.driver import Codec, _pad_np
    codec = Codec(spec, stream_format="compressai")
    seen = []

    class Taken(Exception):
        pass

    def mark(name):
        def f(*args):
            seen.append(name)
            raise Taken
        return f
    codec._split_vq_encode = mark("split encode")
    codec._split_reconstruct = mark("split reconstruct")
    codec.module.encode_front = mark("whole encode")
    codec.module.reconstruct_uint8 = mark("whole reconstruct")
    try:
        x = torch.from_numpy(_pad_np(np.zeros((1, side, 64, 3), np.uint8)))
        with pytest.raises(Taken):
            codec._front(x, None, None)
        with pytest.raises(Taken):
            codec._reconstruct(None, None, None, side, 64)
    finally:
        del codec.module.encode_front, codec.module.reconstruct_uint8
    assert seen == (["split encode", "split reconstruct"] if tiled
                    else ["whole encode", "whole reconstruct"])
