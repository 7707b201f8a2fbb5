"""The training soak (``dc_vic_tpu_torch/tools/soak.py``) against
``scripts/soak.py`` and the TPU's committed verdicts.

(a) The synthetic dataset: ``scripts/soak.py``'s own ``make_synthetic_dataset``
(loaded by path; its module imports only numpy) and the port's on the same
seed and sizes. The script's eval PNGs decode to the port's ``.npy`` arrays
exactly, and the port's training arrays encoded by Pillow as JPEG at quality
92 are the script's files byte for byte: the port trains on the pixels the
script wrote before JPEG.
(b) ``rd_objective`` equals the script's on a grid, exactly.
(c) The gate functions fed the TPU's committed curves
(``docs/artifacts/soak_r3_*``, ``soak_gan_*``, ``curriculum_r5/``) give the
committed verdicts, and the gates' edges: a NaN J fails, five eval points
raise, 69 % of steps non-increasing fails where 70 % passes.
(d) Each mode end to end on the CPU through the run functions, at a small
subnet on 64x64 images for a few iterations: the CSV columns equal the JAX
trainer's (the committed TPU curves' headers), the hand-off checkpoints
exist, each boot took what its knobs say, and the verdict has every gate
key of the script. The s1 -> s2 hand-off at the soak's own widths carries
the count that ``chip_smoke.py`` item 17 holds the card's run to.
"""
import argparse
import copy
import csv
import importlib.util
import io
import json
import logging
import math
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import chip_smoke
import torch_threads  # noqa: F401

from dc_vic_tpu_torch.models import build_comp_model
from dc_vic_tpu_torch.ops import attention, conv3x3, counts, gn, rans_device, vq
from dc_vic_tpu_torch.tools import soak
from dc_vic_tpu_torch.train.trainer import Trainer, build_trainer
from dc_vic_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(ROOT, "docs", "artifacts")
ITERS = 2


def _script():
    spec = importlib.util.spec_from_file_location("tpu_soak_script",
                                                  os.path.join(ROOT, "scripts", "soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _header(path):
    with open(path) as f:
        return next(csv.reader(f))


# ------------------------------------------------------------ (a), (b)
def test_synthetic_dataset_is_the_scripts_pixels_before_jpeg(tmp_path):
    script = _script()
    s_train, s_eval = script.make_synthetic_dataset(str(tmp_path / "tpu"), n_train=3, n_eval=2,
                                                    size=64)
    p_train, p_eval = soak.make_synthetic_dataset(str(tmp_path / "port"), n_train=3, n_eval=2,
                                                  size=64)
    assert sorted(os.listdir(os.path.join(p_train, "train_0"))) == [
        f"img{i:04d}.npy" for i in range(3)]
    assert sorted(os.listdir(p_eval)) == ["kodim00.npy", "kodim01.npy"]
    for i in range(2):
        arr = np.load(os.path.join(p_eval, f"kodim{i:02d}.npy"))
        assert arr.dtype == np.uint8 and arr.shape == (64, 64, 3)
        png = np.asarray(Image.open(os.path.join(s_eval, f"kodim{i:02d}.png")))
        np.testing.assert_array_equal(arr, png)
    for i in range(3):
        buf = io.BytesIO()
        Image.fromarray(np.load(os.path.join(p_train, "train_0", f"img{i:04d}.npy"))).save(
            buf, format="JPEG", quality=92)
        with open(os.path.join(s_train, "train_0", f"img{i:04d}.jpg"), "rb") as f:
            assert buf.getvalue() == f.read(), i


def test_rd_objective_is_the_scripts():
    script = _script()
    assert (soak.W_RATE, soak.W_DIST) == (script.W_RATE, script.W_DIST)
    for bpp in np.linspace(0.0, 3.0, 13):
        for psnr in np.linspace(5.0, 45.0, 17):
            assert soak.rd_objective(float(bpp), float(psnr)) == script.rd_objective(
                float(bpp), float(psnr))


# ------------------------------------------------------------ (c)
def test_rd_gate_reproduces_the_tpu_verdict():
    v = soak.rd_gates(soak.read_csv(os.path.join(ART, "soak_r3_eval.csv")))
    with open(os.path.join(ART, "soak_r3_verdict.txt")) as f:
        curve, flags = f.read().splitlines()
    assert curve == f"J curve: {v['J']}"
    assert flags == f"improved: {v['improved']}, monotone_frac: {v['monotone_frac']:.2f}"
    assert v["J"] == [0.746, 0.404, 0.3207, 0.262, 0.2427, 0.2638]
    assert v["gates"] == {"improved": True, "monotone": True}


def test_gan_gates_reproduce_the_tpu_verdict():
    with open(os.path.join(ART, "soak_gan_verdict.txt")) as f:
        lines = f.read().splitlines()
    p1 = dict(kv.split("=") for kv in lines[0].split(": ")[1].split())
    v = soak.gan_gates(float(p1["psnr"]), float(p1["bpp"]),
                       soak.read_csv(os.path.join(ART, "soak_gan_eval.csv")),
                       soak.read_csv(os.path.join(ART, "soak_gan_loss.csv")))
    p2 = v["phase2"]
    assert lines[1] == (f"phase2: psnr={p2['psnr']:.2f} bpp={p2['bpp']:.4f} "
                        f"d_loss={p2['d_loss']:.4f} skipped={p2['skipped']:.0f}")
    assert f"{p2['d_loss']:.4f}" == "0.4245" and f"{p2['psnr']:.2f}" == "22.58"
    assert lines[2] == f"gates: {v['gates']}"
    assert all(v["gates"].values())


def test_curriculum_gates_reproduce_the_tpu_verdict():
    d = os.path.join(ART, "curriculum_r5")
    rows = lambda s, kind: soak.read_csv(os.path.join(d, f"cur_{s}_{kind}.csv"))
    with open(os.path.join(d, "verdict.json")) as f:
        want = json.load(f)
    got = soak.curriculum_gates(rows("s1", "eval"), rows("s2", "eval"), rows("s3", "eval"),
                                rows("s3", "loss"), rows("s4", "eval"), rows("s4", "loss"))
    assert got == {"stages": want["stages"], "gates": want["gates"]}
    assert len(got["gates"]) == 10 and all(got["gates"].values())


def _rows_of_bpp(bpps, psnr=60.0):
    """Eval rows whose J moves with bpp alone (the MSE term ~5e-5)."""
    return [{"iter": str(i), "beta_rate": "", "beta_vq": "", "bpp": repr(float(b)),
             "psnr": repr(psnr)} for i, b in enumerate(bpps)]


def _steps(down, up, start=2.0):
    """bpp falling 0.02 on ``down`` steps and rising 0.01 (J + 4e-4, over
    the 1e-4 slack) on ``up`` steps, the falls first."""
    out = [start]
    for d in [-0.02] * down + [0.01] * up:
        out.append(out[-1] + d)
    return out


def test_rd_gate_edges():
    ok = soak.rd_gates(_rows_of_bpp(_steps(70, 30)))
    assert ok["monotone_frac"] == 0.70 and ok["gates"] == {"improved": True, "monotone": True}
    short = soak.rd_gates(_rows_of_bpp(_steps(69, 31)))
    assert short["monotone_frac"] == 0.69
    assert short["gates"] == {"improved": True, "monotone": False}
    # a rise inside the slack counts as not rising
    slack = soak.rd_gates(_rows_of_bpp([2.0, 1.9, 1.9 + 0.5e-4 / soak.W_RATE, 1.8, 1.7, 1.6]))
    assert slack["monotone_frac"] == 1.0
    rows = _rows_of_bpp([2.0, 1.9, 1.8, 1.7, 1.6, 1.5])
    rows[-1]["psnr"] = "nan"
    nan = soak.rd_gates(rows)
    assert math.isnan(soak.rd_objective(1.5, float("nan")))
    assert not nan["improved"] and not all(nan["gates"].values())
    with pytest.raises(ValueError, match="6 eval points"):
        soak.rd_gates(_rows_of_bpp([2.0, 1.9, 1.8, 1.7, 1.6]))


def test_gan_gate_edges():
    e = [{"iter": "4", "beta_rate": "0.0", "beta_vq": "0.0", "bpp": "0.5", "psnr": "30"},
         {"iter": "4", "beta_rate": "3.0", "beta_vq": "3.5", "bpp": "0.3", "psnr": "25.0"}]
    loss = lambda d, s=0.0: [{"iter": "4", "d_loss": repr(d), "skipped": repr(s)}]
    assert all(soak.gan_gates(26.4, 0.3, e, loss(0.7))["gates"].values())
    cases = {"zero_nan_skips": (26.4, 0.3, loss(0.7, 0.04)),
             "d_loss_sane": (26.4, 0.3, loss(float("nan"))),
             "psnr_holds": (26.6, 0.3, loss(0.7)),
             "bpp_frozen": (26.4, 0.27, loss(0.7))}
    for gate, (psnr, bpp, rows) in cases.items():
        gates = soak.gan_gates(psnr, bpp, e, rows)["gates"]
        assert [k for k, ok in gates.items() if not ok] == [gate]
    assert not soak.gan_gates(26.4, 0.3, e, loss(0.05))["gates"]["d_loss_sane"]


# ------------------------------------------------------------ (d)
SMALL_PARTS = ("vq_model", "fusion_module", "hyperencoder", "entropy_model_z", "hyperdecoder",
               "context_model", "vq_estimator")


def _small_configs(tmp):
    """The two soak configs with the VQGAN, the hyperprior, the context
    model, the estimator and the discriminator narrowed for 64x64 images
    at batch 2. The ELIC transforms keep the soak's widths: s1's are fixed
    by the curriculum."""
    with open(os.path.join(ART, "soak_gan_config.yaml")) as f:
        gan = yaml.safe_load(f)
    sub = gan["subnet"]
    sub["vq_model"]["ddconfig"].update(ch=8, ch_mult=[1, 1, 1, 2], resolution=64,
                                       attn_resolutions=[8])
    sub["fusion_module"]["fuse_scedule_dict"] = {
        "block_1_8": {"dec_ch": 16, "cond_ch": 64, "mid_ch": 16},
        "block_1_4": {"dec_ch": 8, "cond_ch": 64, "mid_ch": 8},
        "block_1_2": {"dec_ch": 8, "cond_ch": 64, "mid_ch": 8}}
    sub["hyperencoder"]["bottleneck_z"] = 16
    sub["entropy_model_z"]["channels"] = 16
    sub["hyperdecoder"]["hyper_out_ch"] = 32
    sub["context_model"]["slice_mid_ch"] = [16, 16]
    sub["vq_estimator"].update(main_ch=16, blk_depth=1, num_heads=2)
    gan["discriminator"].update(ndf=8, n_layers=2, cond_ch=4, L=4)
    gan["dataset"]["batch_size"] = 2
    gan["dataset"]["train_dataset"]["image_size"] = 64
    with open(os.path.join(ART, "soak_stage1_1_config.yaml")) as f:
        rd = yaml.safe_load(f)
    for k in SMALL_PARTS:
        rd["subnet"][k] = sub[k]
    rd["dataset"] = gan["dataset"]
    paths = {}
    for name, cfg in (("rd", rd), ("gan", gan)):
        paths[name] = os.path.join(tmp, f"small_{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    return paths


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("soak"))
    train_root, eval_root = soak.make_synthetic_dataset(os.path.join(tmp, "data"), n_train=4,
                                                        n_eval=1, size=64)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    configs = _small_configs(tmp)
    out = {}
    try:
        for mode, run, iters, ev in (("rd", soak.run_rd_soak, 6, 1),
                                     ("gan", soak.run_gan_soak, ITERS, 2),
                                     ("curriculum", soak.run_curriculum, ITERS, 2)):
            args = argparse.Namespace(
                iters=iters, eval_step=ev, work=os.path.join(tmp, mode), keep_work=True,
                config=configs["rd" if mode == "rd" else "gan"], no_artifacts=False,
                out=os.path.join(tmp, "artifacts", mode), trace_dir=None, device="cpu")
            verdict, runs = run(args, train_root, eval_root)
            out[mode] = (args, verdict, runs)
    finally:
        torch.set_num_threads(n)
    return out


def _model_dir(args, exp):
    return os.path.join(args.work, "checkpoint", exp, "model")


def test_rd_soak_runs_on_the_cpu(small):
    args, v, _ = small["rd"]
    assert {"J", "improved", "monotone_frac"} <= set(v) and set(v["gates"]) == {
        "improved", "monotone"}
    assert len(v["J"]) == 6 and all(np.isfinite(v["J"]))
    # soak_r3_loss.csv predates the JAX trainer's "skipped" column; its
    # curriculum run wrote the RD trainer's loss columns since
    assert _header(os.path.join(args.out, "soak_r3_eval.csv")) == _header(
        os.path.join(ART, "soak_r3_eval.csv"))
    assert _header(os.path.join(args.out, "soak_r3_loss.csv")) == _header(
        os.path.join(ART, "curriculum_r5", "cur_s1_loss.csv"))
    assert os.path.exists(os.path.join(_model_dir(args, "soak_r3"), "comp_model_iter6.ckpt"))
    stats = v["runs"]["soak_r3"]
    assert stats["steps"] == 6 and stats["nan_skips"] == 0 and stats["handoff"] is None
    # every kernel counted; the wrappers count only launches on the card
    assert stats["launches_per_step"] == {k: 0 for k in soak.kernel_counts()}
    assert {"vq_argmin", "flash_attention", "gn_apply_backward"} <= set(stats["launches_per_step"])


def test_gan_soak_runs_on_the_cpu(small):
    args, v, _ = small["gan"]
    assert set(v["gates"]) == {"zero_nan_skips", "d_loss_sane", "psnr_holds", "bpp_frozen"}
    assert set(v["phase2"]) == {"psnr", "bpp", "d_loss", "skipped"}
    for kind in ("eval", "loss"):
        assert _header(os.path.join(args.out, f"soak_gan_p2_{kind}.csv")) == _header(
            os.path.join(ART, f"soak_gan_{kind}.csv"))
    assert os.path.exists(os.path.join(_model_dir(args, "soak_gan_p1"),
                                       f"comp_model_iter{ITERS}.ckpt"))
    assert sorted(os.listdir(_model_dir(args, "soak_gan_p2"))) == sorted(
        f"{k}_iter{ITERS}.ckpt" for k in ("comp_model", "training_state", "discriminator"))
    boot = v["runs"]["soak_gan_p2"]["handoff"]
    assert boot["strict"] and boot["carried"] == boot["total"] and not boot["kept_init"]
    assert not boot["optimizer"] and not boot["discriminator"]
    assert v["phase2"]["skipped"] == 0 and np.isfinite(v["phase2"]["d_loss"])


def test_curriculum_runs_on_the_cpu(small):
    args, v, stage_runs = small["curriculum"]
    with open(os.path.join(ART, "curriculum_r5", "verdict.json")) as f:
        want = json.load(f)
    assert set(v["gates"]) == set(want["gates"])
    assert {s: set(x) for s, x in v["stages"].items()} == {
        s: set(x) for s, x in want["stages"].items()}
    for s in ("s1", "s2", "s3", "s4"):
        for kind in ("eval", "loss"):
            assert _header(os.path.join(args.out, f"cur_{s}_{kind}.csv")) == _header(
                os.path.join(ART, "curriculum_r5", f"cur_{s}_{kind}.csv"))
        labels = ("comp_model", "training_state") + (("discriminator",) if s in ("s3", "s4")
                                                     else ())
        assert sorted(os.listdir(_model_dir(args, f"cur_{s}"))) == sorted(
            f"{k}_iter{ITERS}.ckpt" for k in labels)
    runs = v["runs"]
    assert runs["s1"]["handoff"] is None
    s1_keys = torch.load(os.path.join(_model_dir(args, "cur_s1"), f"comp_model_iter{ITERS}.ckpt"),
                         map_location="cpu", weights_only=False)
    s2 = runs["s2"]["handoff"]
    assert not s2["strict"] and not s2["optimizer"]
    assert s2["carried"] == len(s1_keys) and s2["carried"] + len(s2["kept_init"]) == s2["total"]
    assert s2["kept_init"] and all(k.startswith(chip_smoke.FILM_KEYS)
                                   for k in s2["kept_init"])
    s3, s4 = runs["s3"]["handoff"], runs["s4"]["handoff"]
    for boot in (s3, s4):
        assert boot["strict"] and boot["carried"] == boot["total"] and not boot["kept_init"]
    assert (s3["optimizer"], s3["discriminator"]) == (False, False)
    assert (s4["optimizer"], s4["discriminator"]) == (True, True)
    assert all(r["nan_skips"] == 0 and r["steps"] == ITERS for r in runs.values())
    for s in ("s3", "s4"):
        assert np.isfinite(v["stages"][s]["d_loss"]) and v["stages"][s]["skipped"] == 0


def test_stage_runs_hold_the_options_each_stage_was_built_from(small):
    """The runs the curriculum returns carry each stage's stats and options;
    a trainer built again from s2's options boots as s2 did (what
    ``chip_smoke.py`` item 17 does for one step under the shape rules)."""
    _, v, runs = small["curriculum"]
    assert {s: r.stats for s, r in runs.items()} == v["runs"]
    assert runs["s2"].opt["load_checkpoint"]["strict"] is False
    assert runs["s4"].opt["load_checkpoint"]["load_discriminator"] is True
    again = build_trainer(copy.deepcopy(runs["s2"].opt), device="cpu")
    boot = v["runs"]["s2"]["handoff"]
    assert len(again.restored["carried"]) == boot["carried"]
    assert sorted(set(again.model.state_dict()) - set(again.restored["carried"])) == boot[
        "kept_init"]


def test_restored_keys_are_the_ones_partial_restore_carries():
    target = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
    raw = {"a": torch.ones(2), "b": torch.ones(4), "d": torch.ones(1)}
    assert Trainer._carried_keys(target, raw) == ["a"]
    merged = Trainer._partial_restore(target, raw, logging.getLogger("t"), "unit")
    assert [k for k, t in merged.items() if t is raw.get(k)] == ["a"]
    assert all(merged[k] is target[k] for k in ("b", "c"))


def test_counts_read_and_reset_every_counter(monkeypatch):
    monkeypatch.setattr(vq, "launches", 3)
    monkeypatch.setattr(attention, "backwards", 2)
    monkeypatch.setitem(gn.launches, "gn_apply", 5)
    monkeypatch.setitem(conv3x3.backwards, "conv3x3_same", 1)
    monkeypatch.setitem(rans_device.launches, "rans_encode_pack", 4)
    assert counts.launches()["vq_argmin"] == 3 and counts.backwards()["flash_attention"] == 2
    assert soak.kernel_counts()["conv3x3_same_backward"] == 1
    counts.reset()
    assert set(counts.launches()) == {"vq_argmin", "flash_attention", "gn_channel_sums",
                                      "gn_apply", "gn_fold", "conv3x3_same", "conv3x3_gn_swish",
                                      "rans_encode_pack", "rans_decode_section"}
    assert not any(counts.launches().values()) and not any(counts.backwards().values())
    assert set(soak.kernel_counts()) == set(counts.launches()) | {
        f"{k}_backward" for k in counts.backwards()}


def test_s2_carries_what_chip_smoke_expects_at_the_soak_widths():
    """s1 -> s2 at the soak's own widths (models built on the CPU, not run):
    every s1 tensor is carried, the beta FiLM is not, and the count is the
    one ``chip_smoke.py`` item 17 holds the card's run to."""
    opt = load_config(soak.GAN_CONFIG, is_train=True)
    s2 = build_comp_model(opt, device="cpu").module.state_dict()
    opt["model"] = {"type": "HyperpriorCharmVicModel", "enc_vq_input": "onehot_indices"}
    opt["subnet"]["encoder"] = dict(soak.S1_ENCODER)
    opt["subnet"]["decoder"] = dict(soak.S1_DECODER)
    s1 = build_comp_model(opt, device="cpu").module.state_dict()
    carried = [k for k, v in s2.items() if k in s1 and s1[k].shape == v.shape]
    assert set(carried) == set(s1)
    assert all(k.startswith(chip_smoke.FILM_KEYS) for k in set(s2) - set(carried))
    assert len(carried) == chip_smoke.SOAK_S2_CARRIED


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        soak.main(["--iters", "1", "--eval_step", "1", "--work", str(tmp_path)])
    assert not os.listdir(tmp_path)
    with pytest.raises(SystemExit):
        soak.main(["--gan", "--curriculum", "--device", "cpu"])
