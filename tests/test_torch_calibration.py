"""The calibration tools and the real LPIPS loss of the port against the
JAX package, on the tiny model with weights carried from flax
(``load_reference_state_dict``): ``vq_indices_to_latent``, the rate
search's ``avg_bpp`` on both paths (token maps and the full forward, f32
rtol 1e-5), ``bisect_beta_rate`` (the same probes and results), the
beta-selection score and CSV rows, the validation-set tool, the LPIPS
loss's value and gradient with respect to the fake images (rtol 1e-4), and
a stage 1_2 trainer step with an LPIPS weights file.
"""
import csv
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import torch_threads  # noqa: F401
from helpers import tiny_config
from train_helpers import _nchw, jax_params

from dc_vic_tpu.metrics import feature_nets as jfn
from dc_vic_tpu.metrics import fid as jfid
from dc_vic_tpu.metrics.image import calc_psnr as jax_psnr
from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import export_state_dict
from dc_vic_tpu.models.dc_vic import likelihood_to_bpp as jax_bpp
from dc_vic_tpu.train.losses import LPIPSLoss as JaxLPIPSLoss
from dc_vic_tpu_torch.metrics.feature_nets import LPIPS, lpips_from_state_dict
from dc_vic_tpu_torch.models import build_comp_model
from dc_vic_tpu_torch.models.convert import load_reference_state_dict
from dc_vic_tpu_torch.tools import beta_selection, binary_rate_search, build_val_dataset
from dc_vic_tpu_torch.tools import train as train_tool
from dc_vic_tpu_torch.tools.workload import metric_state_dicts
from dc_vic_tpu_torch.train.losses import LPIPSLoss
from dc_vic_tpu_torch.utils.logger import get_root_logger

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from binary_rate_search import bisect_beta_rate as jax_bisect  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BETAS = (1.3, 2.2)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_config()
    m = jax_build(cfg).module
    params = jax_params(m, cfg)
    spec = build_comp_model(cfg, device="cpu")
    port = spec.module.eval()
    load_reference_state_dict(port, export_state_dict(params))
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    imgs = binary_rate_search.to_pm1(u8)
    vq_encode = jax.jit(lambda p, x: m.apply(p, x, method=m.vq_encode))
    idx = np.asarray(vq_encode(params, imgs)[1])
    return dict(m=m, params=params, spec=spec, port=port, u8=u8, imgs=imgs,
                idx=idx.astype(np.uint8), jax_vq_encode=vq_encode,
                jax_forward=jax.jit(lambda p, x, b1, b2: m.apply(p, x, b1, b2,
                                                                 is_train=False)),
                jax_qbpp_vq=jax.jit(lambda *a: _jax_qbpp_from_vq(m, *a)))


def test_vq_indices_to_latent_matches_jax(models):
    m, params, port = models["m"], models["params"], models["port"]
    idx = np.random.default_rng(1).integers(0, 32, (2, 8, 8)).astype(np.int32)
    want = np.asarray(m.apply(params, jnp.asarray(idx), method=m.vq_indices_to_latent))
    got = port.vq_indices_to_latent(torch.from_numpy(idx))
    assert got.shape == (2, 4, 8, 8)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).detach().numpy(), want)


def _jax_qbpp_from_vq(m, p, x, idx, b1, b2):
    """The JAX script's token-map fwd (scripts/binary_rate_search.py)."""
    lat = m.apply(p, idx, method=m.vq_indices_to_latent)
    y = m.apply(p, x, lat, idx, b1, b2, method=m.comp_encode)
    ent = m.apply(p, y, is_train=False, method=m.estimate_entropy)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    return jax_bpp(ent["q_likelihoods"]["y"], n) + jax_bpp(ent["q_likelihoods"]["z"], n)


@pytest.mark.parametrize("token_maps", [True, False])
def test_avg_bpp_matches_the_jax_script(models, token_maps):
    """The port's avg_bpp against the JAX script's fwd (its token-map path,
    or the eval forward's qbpp) on the same three images; run at batch 2,
    the port's remainder batch at its own shape gives the same mean."""
    port, imgs, idx = models["port"], models["imgs"], models["idx"]
    maps = idx if token_maps else None
    got = binary_rate_search.make_avg_bpp(port, imgs, batch_size=3, idx_maps=maps)(*BETAS)
    b1, b2 = jnp.array([BETAS[0]], jnp.float32), jnp.array([BETAS[1]], jnp.float32)
    if token_maps:
        want = models["jax_qbpp_vq"](models["params"], imgs, idx.astype(np.int32), b1, b2)
    else:
        want = models["jax_forward"](models["params"], imgs, b1, b2)["qbpp"]
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    by2 = binary_rate_search.make_avg_bpp(port, imgs, batch_size=2, idx_maps=maps)(*BETAS)
    np.testing.assert_allclose(by2, got, rtol=1e-5)


def test_token_map_path_agrees_with_the_forward(models):
    """The codebook lookup of the encoder's own token maps is the forward's
    quantized latent, so both search paths give the same bpp."""
    port, imgs, idx = models["port"], models["imgs"], models["idx"]
    a = binary_rate_search.make_avg_bpp(port, imgs, 8, idx)(*BETAS)
    b = binary_rate_search.make_avg_bpp(port, imgs, 8)(*BETAS)
    np.testing.assert_allclose(a, b, rtol=1e-5)


def test_bisect_beta_rate_probes_as_jax():
    """A stub monotone rate curve, two targets sharing one memo: the same
    probes in the same order and the same (beta_rate, bpp) results as the
    JAX script's function, tolerance reached and not reached."""
    def run(bisect):
        calls = []

        def bpp(beta):
            calls.append(beta)
            return 2.0 * np.exp(-1.1 * beta)
        memo = {}
        out = [bisect(bpp, t, 3.0, memo) for t in (0.25, 0.1)]
        out.append(bisect(bpp, 0.5, 3.0, {}, tol=0.0, max_iters=3))
        return out, calls, sorted(memo)
    assert run(binary_rate_search.bisect_beta_rate) == run(jax_bisect)
    assert (binary_rate_search.TOL, binary_rate_search.MAX_ITERS) == (0.001, 10)
    rows = binary_rate_search.search(lambda br, bv: 2.0 * np.exp(-1.1 * br) / bv, [1.0, 2.0],
                                     [0.25], 3.0)
    assert [(r["beta_vq"], r["target_rate"]) for r in rows] == [(1.0, 0.25), (2.0, 0.25)]
    assert all(abs(r["achieved_bpp"] - 0.25) <= 0.001 for r in rows)


def _jax_to_u8(x):
    return np.round((np.clip(x, -1, 1) / 2 + 0.5) * 255).astype(np.uint8)


def test_beta_selection_rows_match_jax(models, tmp_path):
    """Two candidates of one target rate: the port's reconstruction and
    PSNR against the JAX script's (eval forward, per-image PSNR), FID
    omitted under 50 images, one row selected; the CSV holds the rows."""
    params, port, imgs = models["params"], models["port"], models["imgs"]
    cands = [dict(beta_vq=1.0, target_rate=0.1, beta_rate=2.0, achieved_bpp=0.11),
             dict(beta_vq=2.0, target_rate=0.1, beta_rate=0.5, achieved_bpp=0.09)]
    recon = beta_selection.make_reconstruct(port, imgs, batch_size=2)
    rows = beta_selection.score_candidates(cands, imgs, recon)
    want_scores = []
    for c in cands:
        fakes = np.asarray(models["jax_forward"](
            params, imgs, jnp.array([c["beta_rate"]], jnp.float32),
            jnp.array([c["beta_vq"]], jnp.float32))["fake_images"])
        np.testing.assert_allclose(recon(c["beta_rate"], c["beta_vq"]), fakes, atol=1e-3,
                                   rtol=1e-3)
        want_scores.append(2.0 * np.mean([jax_psnr(imgs[i:i + 1], fakes[i:i + 1])
                                          for i in range(3)]))
    np.testing.assert_allclose([r["score"] for r in rows], want_scores, rtol=1e-3)
    assert [r["selected"] for r in rows] == [bool(s == max(want_scores)) for s in want_scores]
    assert all(r["fid"] is None and r["fid_in_score"] is False for r in rows)
    path = str(tmp_path / "beta_selection_results.csv")
    beta_selection.write_csv(rows, path)
    with open(path) as f:
        read = list(csv.DictReader(f))
    assert list(read[0]) == ["beta_vq", "target_rate", "beta_rate", "achieved_bpp", "psnr",
                             "fid", "score", "fid_in_score", "selected"]
    assert [r["selected"] for r in read] == [str(r["selected"]) for r in rows]
    assert [float(r["score"]) for r in read] == [r["score"] for r in rows]


def test_beta_selection_score_takes_fid_as_jax():
    """With a feature function and 50 images the score is ALPHA * PSNR - FID,
    FID as the JAX package computes it on the same features; the best
    score of each target rate is selected."""
    rng = np.random.default_rng(2)
    imgs = rng.uniform(-1, 1, (50, 256, 256, 3)).astype(np.float32)
    noise = {0.5: 0.05, 0.9: 0.2}
    recon = lambda br, bv: np.clip(imgs + noise[br] * rng.standard_normal(imgs.shape), -1, 1)
    w = rng.standard_normal((3 * 8 * 8, 32))
    feats = lambda p: np.asarray(p, np.float64).reshape(len(p), 8, 32, 8, 32, 3).mean(
        axis=(2, 4)).reshape(len(p), -1) @ w
    cands = [dict(beta_vq=1.0, target_rate=0.1, beta_rate=0.5, achieved_bpp=0.1),
             dict(beta_vq=2.0, target_rate=0.1, beta_rate=0.9, achieved_bpp=0.1)]
    fakes = {}

    def recording(br, bv):
        fakes[br] = recon(br, bv)
        return fakes[br]
    rows = beta_selection.score_candidates(cands, imgs, recording, feats)
    for r in rows:
        f = fakes[r["beta_rate"]]
        psnr = np.mean([jax_psnr(imgs[i:i + 1], f[i:i + 1]) for i in range(50)])
        fid = jfid.compute_fid([_jax_to_u8(x) for x in imgs], [_jax_to_u8(x) for x in f], feats)
        assert r["fid_in_score"] and np.isfinite(fid)
        np.testing.assert_allclose([r["psnr"], r["fid"], r["score"]],
                                   [psnr, fid, beta_selection.ALPHA * psnr - fid], rtol=1e-6)
    assert [r["selected"] for r in rows] == [True, False]


def test_build_val_dataset_crops_and_tokenizes_as_jax(models, tmp_path):
    """The seeded shuffle and crop corners of the JAX script, sources under
    the crop and unreadable ones skipped, the source-exhausted partial batch
    tokenized too; the token maps equal the JAX model's vq_encode."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(3)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)).save(src / f"s{i}.png")
    Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(src / "small.png")
    (src / "broken.jpg").write_bytes(b"not an image")
    cfg_path = tmp_path / "tiny.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(tiny_config().to_plain(), f)
    out = tmp_path / "built"
    build_val_dataset.main(["--config_path", str(cfg_path), "--src_dir", str(src),
                            "--save_dir", str(out), "--num_images", "10", "--crop", "64",
                            "--batch_size", "4", "--device", "cpu"])
    imgs = sorted(os.listdir(out / "images"))
    maps = sorted(os.listdir(out / "vq_indices"))
    assert len(imgs) == 5 and [p.replace(".npy", ".png") for p in maps] == imgs

    # the JAX script's draws: shuffle the sorted paths, then one corner per
    # usable source in that order
    paths = sorted([str(p) for p in src.glob("*.jpg")] + [str(p) for p in src.glob("*.png")])
    jrng = np.random.default_rng(0)
    jrng.shuffle(paths)
    want = []
    for p in paths:
        try:
            img = np.asarray(Image.open(p).convert("RGB"), np.uint8)
        except OSError:
            continue
        if min(img.shape[:2]) < 64:
            continue
        t, l = jrng.integers(0, img.shape[0] - 63), jrng.integers(0, img.shape[1] - 63)
        want.append(img[t:t + 64, l:l + 64])
    got = [np.asarray(Image.open(out / "images" / n)) for n in imgs]
    np.testing.assert_array_equal(np.stack(got), np.stack(want))

    params, port = models["params"], models["port"]
    crops = np.stack(want)
    _, jidx = models["jax_vq_encode"](params, (crops.astype(np.float32) / 255.0 - 0.5) * 2.0)
    tok = build_val_dataset.tokenize(port, crops)
    assert tok.dtype == np.uint8 and tok.shape == (5, 8, 8)
    np.testing.assert_array_equal(tok, np.asarray(jidx))
    built = binary_rate_search.build_model(str(cfg_path), None, "cpu").module
    np.testing.assert_array_equal(np.stack([np.load(out / "vq_indices" / n) for n in maps]),
                                  build_val_dataset.tokenize(built, crops))


@pytest.fixture(scope="module")
def lpips_pair():
    sd = metric_state_dicts(0)["lpips_alex"]
    jparams = jfn.convert_alexnet_lpips(sd)
    port = lpips_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, "alex",
                                 device="cpu")
    return jparams, port


@pytest.mark.parametrize("range_norm", [False, True])
def test_lpips_loss_and_gradient_match_jax(lpips_pair, range_norm):
    jparams, port = lpips_pair
    rng = np.random.default_rng(4)
    real = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    fake = np.clip(real + rng.normal(0, 0.2, real.shape), -1, 1).astype(np.float32)
    if range_norm:
        real, fake = (real + 1) / 2, (fake + 1) / 2
    jloss = JaxLPIPSLoss(loss_weight=0.7, net="alex", range_norm=range_norm)
    jfn_apply = lambda a, b: jfn.LPIPS(net="alex").apply(jparams, a, b)
    want, want_g = jax.jit(jax.value_and_grad(lambda r, f: jloss(r, f, lpips_fn=jfn_apply),
                                              argnums=1))(real, fake)
    loss = LPIPSLoss(loss_weight=0.7, net="alex", range_norm=range_norm)
    f = _nchw(fake).requires_grad_(True)
    got = loss(_nchw(real), f, lpips_fn=port)
    got.backward()
    g = f.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(g, want_g, rtol=1e-4, atol=1e-4 * np.abs(want_g).max())
    assert all(p.grad is None for p in port.parameters())


def _stage12_yaml(tmp, weights):
    """config/exp1_stage1_2.yaml at the tiny widths, on synthetic data."""
    tiny = tiny_config().to_plain()
    data = os.path.join(tmp, "data")
    rng = np.random.default_rng(5)
    for sub, n, size in (("train_0", 2, (72, 80)), ("kodak", 1, (64, 64))):
        os.makedirs(os.path.join(data, sub), exist_ok=True)
        for i in range(n):
            np.save(os.path.join(data, sub, f"img{i}.npy"),
                    rng.integers(0, 256, size + (3,), dtype=np.uint8))
    cfg = {"_base_": os.path.join(ROOT, "config", "exp1_stage1_2.yaml"),
           "subnet": dict(tiny["subnet"], _delete_=True),
           "ckpt_root": os.path.join(tmp, "ckpt"), "seed": 0, "load_checkpoint": None,
           "dataset": {"batch_size": 2,
                       "train_dataset": {"root_dir": data, "subset_list": [0],
                                         "image_size": 64},
                       "eval_dataset": {"root_dir": os.path.join(data, "kodak")}}}
    if weights:
        cfg["lpips_weights"] = weights
    path = os.path.join(tmp, "exp1_stage1_2.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.mark.parametrize("with_weights", [True, False])
def test_trainer_step_with_an_lpips_weights_file(tmp_path, with_weights):
    """With ``lpips_weights`` the stage 1_2 trainer loads the real LPIPS on
    its device, logs ``calibrated=True`` at info level, and its step's
    perceptual term is that network's value on the batch and the fakes;
    without, the proxy and its warning."""
    weights = None
    if with_weights:
        weights = str(tmp_path / "alex.pth")
        torch.save({k: torch.from_numpy(v) for k, v in metric_state_dicts(0)["lpips_alex"]
                    .items()}, weights)
    records = _Records()
    logger = get_root_logger()
    logger.addHandler(records)
    try:
        tr = train_tool.main(["--config_path", _stage12_yaml(str(tmp_path), weights),
                              "--device", "cpu", "dry_run=true"])
    finally:
        logger.removeHandler(records)
    msgs = [(r.levelno, r.getMessage()) for r in records.records if "perceptual" in r.getMessage()]
    if not with_weights:
        assert tr.lpips_fn is None
        assert msgs == [(logging.WARNING, "perceptual_loss calibrated=False — LPIPS weights "
                                          "missing, using gradient-L1 proxy")]
        return
    assert msgs == [(logging.INFO, "perceptual_loss calibrated=True")]
    assert isinstance(tr.lpips_fn, LPIPS) and not tr.lpips_fn.training
    frozen = {k: v.clone() for k, v in tr.lpips_fn.state_dict().items()}
    seen = []
    hook = tr.lpips_fn.register_forward_hook(lambda mod, args, out: seen.append(
        (args[0].detach(), args[1].detach(), out.detach())))
    batch = tr._to_device(next(tr.train_loader.infinite())["real_images"])
    dec0 = {n: p.detach().clone() for n, p in tr.model.named_parameters()
            if n.startswith("decoder.")}
    try:
        terms = tr.step(batch)
    finally:
        hook.remove()
    assert len(seen) == 1 and torch.equal(seen[0][0], batch)
    np.testing.assert_allclose(float(terms["perceptual"]), float(torch.mean(seen[0][2])),
                               rtol=1e-6)
    assert np.isfinite(float(terms["total"])) and float(terms["skipped"]) == 0.0
    assert any(not torch.equal(dec0[n], p) for n, p in tr.model.named_parameters()
               if n in dec0)
    assert all(torch.equal(frozen[k], v) for k, v in tr.lpips_fn.state_dict().items())
