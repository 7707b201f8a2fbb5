"""The port's parallel layer on the CPU (no JAX): ``parallel/mesh.py``'s
arithmetic and collectives, the loader's rank shares, and the multi-device
codec (``Codec(spec, mesh=...)``) on the tiny model with CPU entries, held
as the JAX package's ``tests/test_codec_mesh.py`` holds its mesh codec:
bit-exact round trips, a batch that does not divide padded, pixels close to
the single-device codec's (under 2% differing, at most 2 steps), portable
streams bit-exact in both directions, and non-portable ones refused at
another padded batch. Here the latents also equal the single-device
codec's bit for bit."""
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from helpers import tiny_config

from dc_vic_tpu_torch.codec.container import HeaderHandler
from dc_vic_tpu_torch.codec.driver import Codec
from dc_vic_tpu_torch.data.datasets import OpenImageImageDataset
from dc_vic_tpu_torch.data.loader import HostDataLoader
from dc_vic_tpu_torch.models import build_comp_model, init_weights
from dc_vic_tpu_torch.parallel import mesh as pm


# (global batch, devices, best mesh size): dc_vic_tpu/parallel/mesh.py:27's
# arithmetic, the largest count up to ``devices`` that divides the batch
@pytest.mark.parametrize("batch,devices,want", [
    (6, 8, 6), (6, 4, 3), (6, 1, 1), (16, 8, 8), (16, 4, 4), (15, 4, 3), (7, 4, 1),
    (24, 5, 4), (1, 8, 1), (12, 12, 12), (24, 4, 4), (9, 2, 1)])
def test_best_mesh_size(batch, devices, want):
    assert pm.best_mesh_size(batch, devices) == want


def test_make_mesh_and_shard_rows():
    assert pm.make_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert pm.make_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pm.make_mesh()
    assert pm.shard_rows(6, 1, 2) == [3, 4, 5]
    assert pm.shard_rows(8, 1, 2, groups=2) == [2, 3, 6, 7]
    assert pm.shard_rows(9, 0, 2, groups=2) == [0, 1, 4, 5]      # the odd row is left out
    x = torch.arange(12)
    assert pm.shard_batch(x, 2, 3).tolist() == [8, 9, 10, 11]
    assert pm.shard_batch(x, 0, 2, groups=2).tolist() == [0, 1, 2, 6, 7, 8]
    assert pm.shard_batch(np.arange(12), 1, 2, groups=2).tolist() == [3, 4, 5, 9, 10, 11]
    with pytest.raises(ValueError):
        pm.shard_rows(6, 0, 4)
    with pytest.raises(ValueError):
        pm.init_distributed(0, 1, "mpi", "file:///nonexistent")


def test_world_of_one_collectives_are_exact(tmp_path):
    """A 1-rank gloo group: the averaged gradients and scalars are the
    rank's own bits, written back into ``.grad`` where one exists."""
    dp = pm.init_distributed(0, 1, "gloo", f"file://{tmp_path / 'store'}")
    try:
        gen = torch.Generator().manual_seed(0)
        params = [torch.nn.Parameter(torch.randn(3, 4, generator=gen)) for _ in range(3)]
        params[0].grad = torch.randn(3, 4, generator=gen)
        params[2].grad = torch.randn(3, 4, generator=gen)
        before = [None if p.grad is None else p.grad.clone() for p in params]
        got = dp.mean_grads(params)
        assert torch.equal(got[0], before[0]) and torch.equal(got[2], before[2])
        assert torch.equal(got[1], torch.zeros(3, 4)) and params[1].grad is None
        assert torch.equal(params[2].grad, before[2])
        terms = {"total": torch.tensor(1.25), "bpp": torch.tensor(0.5)}
        assert dp.all_reduce_mean(terms) == terms
        dp.barrier()
    finally:
        pm.teardown()


@pytest.mark.parametrize("world,groups", [(2, 1), (3, 1), (3, 2)])
def test_rank_shares_of_the_loader_are_its_batches(tmp_path, world, groups):
    """Every rank's batches, put back in row order, are the single-process
    loader's: the same order, crops and flips over two epochs; each rank
    decodes only its own rows."""
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "train_0")
    for i in range(14):
        np.save(tmp_path / "train_0" / f"img{i:02d}.npy",
                rng.integers(0, 256, (40 + i, 52 - i, 3), dtype=np.uint8))
    ds = OpenImageImageDataset(str(tmp_path), subset_list=[0], image_size=32)
    whole = HostDataLoader(ds, 6, num_workers=2, seed=5)
    ranks = [HostDataLoader(ds, 6, num_workers=2, seed=5, rank=r, world=world, groups=groups)
             for r in range(world)]
    for epoch in range(2):
        batches = list(zip(whole.epoch_batches(epoch), *(ld.epoch_batches(epoch)
                                                         for ld in ranks)))
        assert len(batches) == len(whole) == 2
        for want, *parts in batches:
            rows = [pm.shard_rows(6, r, world, groups) for r in range(world)]
            got = np.zeros_like(want["real_images"])
            for r, part in enumerate(parts):
                assert len(part["paths"]) == 6 // world
                got[rows[r]] = part["real_images"]
                assert part["paths"] == [want["paths"][i] for i in rows[r]]
            np.testing.assert_array_equal(got, want["real_images"])


# ------------------------------------------------------------------ codec

@pytest.fixture(scope="module")
def spec():
    s = build_comp_model(tiny_config(), device="cpu")
    init_weights(s.module, torch.Generator().manual_seed(0))
    return s


def _images(B, H=64, W=64):
    """tests/test_codec_mesh.py's images: a ramp plus noise."""
    rng = np.random.default_rng(3)
    base = np.linspace(0, 255, W, dtype=np.float32)[None, None, :, None]
    return np.clip(base + rng.normal(0, 25, (B, H, W, 3)), 0, 255).astype(np.uint8)


def _round_trip(codec, imgs, quality=1):
    res = codec.compress(imgs, quality, debug=True)
    strings = [r["string_list"] for r in res]
    return res, strings


@pytest.mark.parametrize("fmt", ["tpu", "compressai"])
def test_mesh_round_trip_is_bit_exact_and_equals_one_device(spec, fmt):
    """Mesh of two: the round trip's latents bit-exact, the images of the
    batch's shape, and the latents equal to the single-device codec's."""
    imgs = _images(6)
    mc = Codec(spec, stream_format=fmt, mesh=["cpu", "cpu"])
    assert mc.params_backend == "accel" and len(mc._shards) == 2
    res, strings = _round_trip(mc, imgs)
    assert len(res) == 6 and mc.verify_roundtrip(res, strings, (64, 64))
    out = mc.decompress(strings)
    assert out.shape == imgs.shape and out.dtype == np.uint8
    ref, _ = _round_trip(Codec(spec, stream_format=fmt), imgs)
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(a["y_hat"], b["y_hat"])
        np.testing.assert_array_equal(a["z_hat"], b["z_hat"])


def test_mesh_pads_a_batch_that_does_not_divide(spec):
    """Six images on a mesh of four run as eight: every output has six
    entries, the header records the padded batch, deferred fetches drop the
    pad too."""
    mc = Codec(spec, mesh=["cpu"] * 4)
    imgs = _images(6)
    res, strings = _round_trip(mc, imgs)
    assert len(res) == 6 and mc.verify_roundtrip(res, strings, (64, 64))
    assert {HeaderHandler.decode(s[0])["encode_batch"] for s in strings} == {8}
    out = mc.decompress(strings)
    assert out.shape == imgs.shape
    np.testing.assert_array_equal(mc.decompress(strings, defer_fetch=True).fetch(), out)
    # the two phases, two batches in flight
    handles = [mc.compress_dispatch(imgs[:5], 1), mc.compress_dispatch(imgs, 1)]
    got = [mc.compress_finalize(h) for h in handles]
    assert [len(g) for g in got] == [5, 6]
    assert [r["string_list"] for r in got[1]] == strings


def test_mesh_pixels_within_the_jax_tests_bounds(spec):
    """Shards of two against one batch of eight: the reconstructions run at
    other batch shapes, so pixels may flip at rounding boundaries; the JAX
    test's bounds (tests/test_codec_mesh.py:93-109) hold."""
    imgs = _images(8)
    ref = Codec(spec).decompress(_round_trip(Codec(spec), imgs, 2)[1])
    mc = Codec(spec, mesh=["cpu"] * 4)
    out = mc.decompress(_round_trip(mc, imgs, 2)[1])
    diff = out.astype(np.int32) - ref.astype(np.int32)
    assert np.mean(diff != 0) < 0.02
    assert np.abs(diff).max() <= 2


def test_portable_streams_cross_between_mesh_and_one_device(spec):
    """Portable streams from a mesh decode bit-exactly on one device, per
    image and in a group of three, and the reverse
    (tests/test_codec_mesh.py:112-150)."""
    imgs = _images(6)
    mc = Codec(spec, portable=True, mesh=["cpu"] * 4)
    sc = Codec(spec, portable=True)
    res, strings = _round_trip(mc, imgs)
    assert mc.verify_roundtrip(res, strings, (64, 64))
    for b in range(len(strings)):
        assert sc.verify_roundtrip([res[b]], [strings[b]], (64, 64)), b
    assert sc.verify_roundtrip(res[:3], strings[:3], (64, 64))
    assert sc.decompress(strings[:3]).shape == (3, 64, 64, 3)
    res, strings = _round_trip(sc, imgs)
    assert mc.verify_roundtrip(res, strings, (64, 64))
    assert mc.verify_roundtrip(res[1:4], strings[1:4], (64, 64))
    assert mc.decompress(strings).shape == imgs.shape


def test_non_portable_stream_refused_at_another_padded_batch(spec):
    """A batch of six from a mesh of four records batch eight: one device
    at six and a mesh of two (six) refuse it, a mesh of four takes it; the
    cpu parameter backend is refused under a mesh."""
    _, strings = _round_trip(Codec(spec, mesh=["cpu"] * 4), _images(6))
    for other in (Codec(spec), Codec(spec, mesh=["cpu", "cpu"])):
        with pytest.raises(ValueError, match="encoded at batch 8"):
            other.decompress(strings)
    assert Codec(spec, mesh=["cpu"] * 4).decompress(strings).shape == (6, 64, 64, 3)
    with pytest.raises(ValueError, match="mesh"):
        Codec(spec, stream_format="compressai", params_backend="cpu", mesh=["cpu", "cpu"])
