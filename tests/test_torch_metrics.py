"""The port's perceptual and distribution metrics against the JAX package's
on the same seeded weights and inputs: AlexNet and VGG16 taps, LPIPS (alex,
vgg), DISTS, InceptionV3 pool3 features, FID and the calc_metrics dict.

One torchvision-layout state dict per network is drawn with numpy's
default_rng (``tools/workload.py::metric_state_dicts``); the JAX modules get
it through the JAX package's converters (jitted once per module-scoped
fixture), the port loads it by name, so the converters are under test too.
Tolerances, f32: taps and features rtol 1e-4, atol 1e-5; LPIPS and DISTS
atol 1e-5; FID 1e-6 relative.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_threads  # noqa: F401

from dc_vic_tpu.metrics import feature_nets as jfn
from dc_vic_tpu.metrics import fid as jfid
from dc_vic_tpu.metrics import image as jimage
from dc_vic_tpu.metrics import inception as jinc
from dc_vic_tpu_torch.metrics import feature_nets as fn
from dc_vic_tpu_torch.metrics import fid
from dc_vic_tpu_torch.metrics import inception
from dc_vic_tpu_torch.tools.calc_metrics import calc_metrics_arrays
from dc_vic_tpu_torch.tools.workload import metric_state_dicts

FEAT_TOL = dict(rtol=1e-4, atol=1e-5)
DIST_TOL = dict(rtol=0, atol=1e-5)


def _torch_sd(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def nets():
    sds = metric_state_dicts(0)
    alex, vgg, dists, inc = sds["lpips_alex"], sds["lpips_vgg"], sds["dists"], sds["inception"]

    lp = {"alex": jfn.convert_alexnet_lpips(alex),
          "vgg": {"params": {"backbone": jfn.convert_vgg16_features(vgg, "net.features"),
                             **{f"lin{i}": vgg[f"lin{i}.model.1.weight"].reshape(-1)
                                for i in range(5)}}}}
    dparams = {"params": {"backbone": jfn.convert_vgg16_features(dists, "vgg16.features"),
                          "alpha": dists["alpha"].reshape(-1),
                          "beta": dists["beta"].reshape(-1)}}
    return dict(
        sd=dict(alex=alex, vgg=vgg, dists=dists, inception=inc),
        jax_alex=jax.jit(lambda x: jfn.AlexNetFeatures().apply(
            {"params": lp["alex"]["params"]["backbone"]}, x)),
        jax_vgg=jax.jit(lambda x: jfn.VGG16Features().apply(
            {"params": lp["vgg"]["params"]["backbone"]}, x)),
        jax_lpips={n: jax.jit(lambda a, b, n=n: jfn.LPIPS(net=n).apply(lp[n], a, b))
                   for n in ("alex", "vgg")},
        jax_dists=jax.jit(lambda a, b: jfn.DISTS().apply(dparams, a, b)),
        jax_inception=jax.jit(lambda x: jinc.InceptionV3Features().apply(
            jinc.convert_inception(inc), x)),
        lpips={n: fn.lpips_from_state_dict(_torch_sd(sd), n, device="cpu")
               for n, sd in (("alex", alex), ("vgg", vgg))},
        dists=fn.dists_from_state_dict(_torch_sd(dists), device="cpu"),
        inception=inception.inception_from_state_dict(_torch_sd(inc), device="cpu"))


def _pair(seed, shape=(2, 64, 64, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    return a, np.clip(a + rng.normal(0, 0.2, shape), -1, 1).astype(np.float32)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_backbone_taps_match_jax(nets, net):
    x, _ = _pair(1, (2, 64, 64, 3) if net == "alex" else (2, 32, 32, 3))
    want = nets[f"jax_{net}"](jnp.asarray(x))
    with torch.no_grad():
        got = nets["lpips"][net].net(_nchw(x))
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), **FEAT_TOL,
                                   err_msg=f"{net} tap {i}")


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax(nets, net):
    a, b = _pair(2, (2, 64, 64, 3) if net == "alex" else (2, 32, 32, 3))
    want = np.asarray(nets["jax_lpips"][net](jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = nets["lpips"][net](_nchw(a), _nchw(b)).numpy()
    assert got.shape == (2,) and np.all(got > 0)
    np.testing.assert_allclose(got, want, **DIST_TOL)


def test_dists_matches_jax(nets):
    a, b = _pair(3, (2, 32, 32, 3))
    a, b = (a + 1) / 2, (b + 1) / 2
    want = np.asarray(nets["jax_dists"](jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = nets["dists"](_nchw(a), _nchw(b)).numpy()
    assert got.shape == (2,) and np.all(got > 0)
    np.testing.assert_allclose(got, want, **DIST_TOL)


def test_inception_resize_matches_jax():
    """256 -> 299 bilinear with half-pixel centres: F.interpolate without
    antialias is jax.image.resize's upsampling."""
    x = np.random.default_rng(4).uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), "bilinear"))
    got = F.interpolate(_nchw(x), size=(299, 299), mode="bilinear", align_corners=False,
                        antialias=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_inception_pool3_matches_jax(nets):
    x = np.random.default_rng(5).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    want = np.asarray(nets["jax_inception"](jnp.asarray(x)))
    with torch.no_grad():
        got = nets["inception"](torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048) and np.isfinite(got).all() and np.std(got) > 0
    np.testing.assert_allclose(got, want, **FEAT_TOL)


def _patch_features(patches):
    """A fixed map of [N, 256, 256, 3] uint8 patches to 256-d features
    (both FID copies get the same function)."""
    w = np.random.default_rng(6).standard_normal((3 * 16 * 16, 256))
    small = np.asarray(patches, np.float32).reshape(len(patches), 16, 16, 16, 16, 3)
    return small.mean(axis=(2, 4)).reshape(len(patches), -1).astype(np.float64) @ w / 255.0


def test_compute_fid_matches_jax_on_the_same_features():
    """50 image pairs (FID's minimum) of 384 x 384: one patch a tiling, two
    an image; fewer than 50 images or no feature function give None. A
    768 x 512 image gives the two tilings' eight patches in both copies."""
    rng = np.random.default_rng(7)
    reals = [rng.integers(0, 256, (384, 384, 3), dtype=np.uint8) for _ in range(fid.MIN_IMAGES)]
    fakes = [np.clip(r.astype(np.int16) + rng.integers(-20, 21, r.shape), 0, 255)
             .astype(np.uint8) for r in reals]
    big = [np.zeros((512, 768, 3), np.uint8)]
    for a, b in zip(fid.collect_patches(big + reals[:1]), jfid.collect_patches(big + reals[:1])):
        np.testing.assert_array_equal(a, b)
    assert len(fid.collect_patches(big)) == 8 and len(fid.collect_patches(reals[:1])) == 2
    want = jfid.compute_fid(reals, fakes, _patch_features, batch_size=32)
    got = fid.compute_fid(reals, fakes, _patch_features, batch_size=32)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert fid.compute_fid(reals[:-1], fakes[:-1], _patch_features) is None
    assert fid.compute_fid(reals, fakes, None) is None


def test_frechet_distance_on_a_singular_covariance():
    """Fewer samples than dimensions: a singular covariance whose root may be
    complex; the port's copy takes the reference's path to the same
    value."""
    rng = np.random.default_rng(8)
    f1, f2 = rng.standard_normal((20, 64)), rng.standard_normal((20, 64)) + 0.3
    (m1, s1), (m2, s2) = fid.gaussian_stats(f1), fid.gaussian_stats(f2)
    assert np.linalg.matrix_rank(s1) < 64
    want = jfid.frechet_distance(m1, s1, m2, s2)
    got = fid.frechet_distance(m1, s1, m2, s2)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_loaders_read_the_keys_the_jax_loaders_read(nets, tmp_path):
    """A torch.save'd file under each key layout the JAX converters accept
    (net.features / features, lin{i} / lins.{i}; vgg16.features / features
    with alpha, beta; Inception with fc, AuxLogits and num_batches_tracked)
    loads to the same frozen network, on which gradients reach the inputs
    only."""
    sd = nets["sd"]
    alt_alex = {re.sub(r"^lin(\d)", r"lins.\1", k.replace("net.features", "features")): v
                for k, v in sd["alex"].items()}
    assert "lins.0.model.1.weight" in alt_alex and "features.0.weight" in alt_alex
    alt_dists = {k.replace("vgg16.features", "features"): v for k, v in sd["dists"].items()}
    files = {}
    for name, d in (("alex", sd["alex"]), ("alex_alt", alt_alex), ("vgg", sd["vgg"]),
                    ("dists", sd["dists"]), ("dists_alt", alt_dists),
                    ("inception", sd["inception"])):
        files[name] = str(tmp_path / f"{name}.pth")
        torch.save(_torch_sd(d), files[name])
    assert fn.load_lpips(None) is None and fn.load_dists(None) is None

    a, b = _pair(9, (1, 64, 64, 3))
    ta, tb = _nchw(a), _nchw(b).requires_grad_(True)
    for name, net in (("alex", "alex"), ("alex_alt", "alex"), ("vgg", "vgg")):
        m = fn.load_lpips(files[name], net, device="cpu")
        assert not m.training and not any(p.requires_grad for p in m.parameters())
        ref = nets["lpips"][net]
        assert all(torch.equal(p, q) for p, q in zip(m.state_dict().values(),
                                                     ref.state_dict().values()))
    out = m(ta, tb).sum()
    out.backward()
    assert tb.grad is not None and torch.isfinite(tb.grad).all() and tb.grad.abs().sum() > 0
    assert all(p.grad is None for p in m.parameters())
    jax_fn = jfn.load_lpips(files["alex"], "alex")
    np.testing.assert_allclose(
        fn.load_lpips(files["alex"], "alex", device="cpu")(ta, tb).detach().numpy(),
        np.asarray(jax_fn(jnp.asarray(a), jnp.asarray(b))), **DIST_TOL)
    for name in ("dists", "dists_alt"):
        m = fn.load_dists(files[name], device="cpu")
        assert all(torch.equal(p, q) for p, q in zip(m.state_dict().values(),
                                                     nets["dists"].state_dict().values()))
    feats = inception.load_inception(files["inception"], device="cpu")
    x = np.random.default_rng(10).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    with torch.no_grad():
        want = nets["inception"](torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(feats(x), want)


def test_calc_metrics_arrays_matches_jax(nets):
    """Three pairs of 168 x 168 images (MS-SSIM needs more than 160 px):
    the dict's numbers against the JAX package's metric functions and
    networks on the same pairs; FID skipped under 50 images."""
    rng = np.random.default_rng(11)
    reals = [rng.integers(0, 256, (168, 168, 3), dtype=np.uint8) for _ in range(3)]
    fakes = [np.clip(r.astype(np.int16) + rng.integers(-30, 31, r.shape), 0, 255)
             .astype(np.uint8) for r in reals]
    got = calc_metrics_arrays(reals, fakes, lpips=nets["lpips"]["alex"], dists=nets["dists"],
                              inception=lambda x: np.zeros((len(x), 4)), bitrate=0.25)
    pm1 = lambda u8: (u8.astype(np.float32) / 255.0 - 0.5) * 2.0
    psnr = np.mean([jimage.calc_psnr(pm1(r)[None], pm1(f)[None]) for r, f in zip(reals, fakes)])
    msssim = np.mean([jimage.calc_ms_ssim(pm1(r)[None], pm1(f)[None])
                      for r, f in zip(reals, fakes)])
    lpips = np.mean([float(nets["jax_lpips"]["alex"](pm1(r)[None], pm1(f)[None])[0])
                     for r, f in zip(reals, fakes)])
    unit = lambda u8: u8[None] / np.float32(255)
    dists = np.mean([float(nets["jax_dists"](unit(r), unit(f))[0]) for r, f in zip(reals, fakes)])
    assert set(got) == {"bitrate", "psnr", "ms_ssim", "fid", "lpips", "dists", "num_images",
                        "skipped"}
    assert got["bitrate"] == 0.25 and got["num_images"] == 3 and got["fid"] is None
    assert got["skipped"] == ["fid (needs >= 50 images, got 3)"]
    np.testing.assert_allclose(got["psnr"], psnr, rtol=1e-12)
    np.testing.assert_allclose(got["ms_ssim"], msssim, rtol=1e-5)
    np.testing.assert_allclose(got["lpips"], lpips, **DIST_TOL)
    np.testing.assert_allclose(got["dists"], dists, **DIST_TOL)
    none = calc_metrics_arrays(reals, fakes)
    assert none["lpips"] is none["dists"] is none["fid"] is None
    assert none["skipped"] == ["lpips (no weights: pass --lpips_weights)",
                               "dists (no weights: pass --dists_weights)",
                               "fid (no weights: pass --inception_weights)"]
