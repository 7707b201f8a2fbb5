"""The curriculum of the dual-beta stages on the tiny model: stage 1_2 (RD)
-> 1_3 (GAN, booting 1_2's checkpoint with the shipped knobs) -> 3 (GAN,
booting 1_3's with its optimizer and discriminator), each a few iterations
over synthetic PNGs written from a seed, through ``tools/train.py`` with the
repository's ``config/exp1_stage*.yaml`` (widths from the tiny config). The
port's counterpart of ``tests/test_curriculum.py``; also the saver's names
and keep/delete rule, the partial restore and the datasets against the JAX
package's.
"""
import logging
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import torch_threads  # noqa: F401
from helpers import tiny_config

from dc_vic_tpu.data.datasets import BaseImageDataset as JaxDataset
from dc_vic_tpu.data.datasets import random_resize as jax_random_resize
from dc_vic_tpu.utils.paths import iter2str as jax_iter2str
from dc_vic_tpu_torch.data.datasets import BaseImageDataset, random_resize
from dc_vic_tpu_torch.data.loader import HostDataLoader
from dc_vic_tpu_torch.tools import train as train_tool
from dc_vic_tpu_torch.train.saver import Saver
from dc_vic_tpu_torch.train.trainer import Trainer
from dc_vic_tpu_torch.utils.paths import iter2str

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 2


def _write_pngs(root, n, size, seed):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        arr = rng.integers(0, 256, size + (3,), dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"img{i}.png"))


def _stage_yaml(tmp, stage, load):
    """config/exp1_stage{stage}.yaml at the tiny widths on the synthetic
    data, ITERS iterations, saving and validating at the last."""
    tiny = tiny_config().to_plain()
    cfg = {
        "_base_": os.path.join(ROOT, "config", f"exp1_stage{stage}.yaml"),
        "subnet": dict(tiny["subnet"], _delete_=True),
        "ckpt_root": os.path.join(tmp, "ckpt"), "seed": 0,
        "total_iter": ITERS, "log_step": 1, "eval_step": ITERS, "save_step": ITERS,
        "keep_step": [ITERS],
        "dataset": {"batch_size": 2,
                    "train_dataset": {"root_dir": os.path.join(tmp, "data"),
                                      "subset_list": [0], "image_size": 64},
                    "eval_dataset": {"root_dir": os.path.join(tmp, "data", "kodak")}},
        "discriminator": {"ndf": 8, "n_layers": 2, "cond_ch": 4, "L": 4},
        "load_checkpoint": dict(load, _delete_=True) if load else None,
    }
    path = os.path.join(tmp, f"exp1_stage{stage}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def curriculum(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("curriculum"))
    _write_pngs(os.path.join(tmp, "data", "train_0"), 4, (72, 80), 0)
    _write_pngs(os.path.join(tmp, "data", "kodak"), 1, (64, 96), 1)
    model_dir = lambda exp: os.path.join(tmp, "ckpt", exp, "model")
    t12 = train_tool.main(["--config_path", _stage_yaml(tmp, "1_2", None), "--device", "cpu"])
    saved12 = Saver.load(os.path.join(model_dir("exp1_stage1_2"), f"comp_model_iter{ITERS}.ckpt"))
    # the shipped 1_3 knobs: weights only, partial restore; built with
    # dry_run (the tool returns the trainer untrained), then trained
    t13 = train_tool.main(["--config_path", _stage_yaml(tmp, "1_3", {
        "path": os.path.join(model_dir("exp1_stage1_2"), f"comp_model_iter{ITERS}.ckpt"),
        "load_optimizer": False, "load_scheduler": False, "strict": False}),
        "--device", "cpu", "dry_run=true"])
    booted13 = {k: v.clone() for k, v in t13.model.state_dict().items()}
    t13.train_loop()
    d13 = model_dir("exp1_stage1_3")
    cfg3 = {"path": os.path.join(d13, f"comp_model_iter{ITERS}.ckpt"),
            "training_state_path": os.path.join(d13, f"training_state_iter{ITERS}.ckpt"),
            "discriminator_path": os.path.join(d13, f"discriminator_iter{ITERS}.ckpt"),
            "load_optimizer": True, "load_scheduler": False, "strict": True}
    path3 = _stage_yaml(tmp, "3", cfg3)
    opt3 = train_tool.load_config(path3, overrides=["dry_run=true"], is_train=True)
    t3 = train_tool.build_trainer(opt3, device="cpu")
    boot3 = dict(sched_count=int(t3.state.g_opt.sched_count), count=int(t3.state.g_opt.count),
                 disc={k: v.clone() for k, v in t3.state.disc.state_dict().items()})
    t3.train_loop()
    return dict(tmp=tmp, t12=t12, t13=t13, t3=t3, saved12=saved12, booted13=booted13,
                boot3=boot3, model_dir=model_dir)


def test_stages_save_their_checkpoints(curriculum):
    md = curriculum["model_dir"]
    for exp, labels in (("exp1_stage1_2", ("comp_model", "training_state")),
                        ("exp1_stage1_3", ("comp_model", "training_state", "discriminator")),
                        ("exp1_stage3", ("comp_model", "training_state", "discriminator"))):
        assert sorted(os.listdir(md(exp))) == sorted(f"{lb}_iter{ITERS}.ckpt" for lb in labels)
    ts = Saver.load(os.path.join(md("exp1_stage1_3"), f"training_state_iter{ITERS}.ckpt"))
    assert set(ts) == {"g_opt", "aux_opt", "step", "d_opt"} and ts["step"] == ITERS


def test_stage_boots_carry_what_their_knobs_say(curriculum):
    """1_3 takes 1_2's weights (strict false: every key present loads);
    stage 3 takes 1_3's optimizer with the schedule reset (Adam's count
    kept) and 1_3's discriminator."""
    for k, v in curriculum["saved12"].items():
        assert torch.equal(curriculum["booted13"][k], v), k
    t13 = curriculum["t13"]
    assert (int(t13.state.g_opt.count), int(t13.state.g_opt.sched_count)) == (ITERS, ITERS)
    assert curriculum["boot3"]["sched_count"] == 0 and curriculum["boot3"]["count"] == ITERS
    saved_d = Saver.load(os.path.join(curriculum["model_dir"]("exp1_stage1_3"),
                                      f"discriminator_iter{ITERS}.ckpt"))
    for k, v in saved_d.items():
        assert torch.equal(curriculum["boot3"]["disc"][k], v), k


def test_stages_train_what_their_masks_say(curriculum):
    """The frozen prior is bit-identical through all three stages; the GAN
    stages move the decoder and leave the encoder; validation wrote a row
    per beta corner in every stage."""
    saved12, t3 = curriculum["saved12"], curriculum["t3"]
    final = t3.model.state_dict()
    for k, v in saved12.items():
        if k.startswith("vq_model."):
            assert torch.equal(final[k], v), k
        if k.startswith("encoder."):
            assert torch.equal(final[k], v), k
    assert any(not torch.equal(final[k], v) for k, v in saved12.items()
               if k.startswith("decoder."))
    for exp in ("exp1_stage1_2", "exp1_stage1_3", "exp1_stage3"):
        with open(os.path.join(curriculum["tmp"], "ckpt", exp, "eval_result.csv")) as f:
            rows = f.read().strip().splitlines()
        assert len(rows) == 1 + 4 and rows[0].startswith("iter,beta_rate,beta_vq,bpp,psnr")
        assert all(np.isfinite(float(x)) for x in rows[-1].split(",")[3:])


def test_saver_names_and_keep_rule(tmp_path):
    """{label}_iter{N|NK}.ckpt; a label's previous checkpoint is deleted
    unless its iteration is a kept step."""
    for itr in (1, 999, 1000, 1500, 500000):
        assert iter2str(itr) == jax_iter2str(itr)
    saver = Saver(str(tmp_path), keep_steps=[2000])
    for itr in (1000, 2000, 3000, 4000):
        saver.save({"comp_model": {"w": torch.zeros(1)}}, itr)
    assert sorted(os.listdir(tmp_path)) == ["comp_model_iter2K.ckpt", "comp_model_iter4K.ckpt"]
    saver.save({"comp_model": {"w": torch.ones(1)}}, 4500, keep=True)
    saver.save({"comp_model": {"w": torch.ones(1)}}, 5000)
    assert "comp_model_iter4500.ckpt" in os.listdir(tmp_path)
    assert "comp_model_iter4K.ckpt" not in os.listdir(tmp_path)


def test_partial_restore():
    """strict false: matching keys load, missing ones keep their values,
    unexpected ones and shape mismatches are ignored."""
    target = {"a": torch.zeros(2, 2), "b": torch.zeros(3), "c": torch.zeros(2)}
    raw = {"a": torch.ones(2, 2), "c": torch.ones(5), "zz": torch.ones(1)}
    out = Trainer._partial_restore(target, raw, logging.getLogger("t"), "unit")
    assert torch.equal(out["a"], torch.ones(2, 2))
    assert torch.equal(out["b"], torch.zeros(3)) and torch.equal(out["c"], torch.zeros(2))
    assert "zz" not in out


def test_dataset_matches_jax(tmp_path):
    """Random crop (reflect-padded when small) and flip from the same numpy
    rng give the JAX dataset's pixels exactly; the random resize (antialiased
    bilinear in torch, Pillow's in JAX) stays within two uint8 steps of it
    on 98% of pixels. .npy images load as the PNGs do."""
    _write_pngs(str(tmp_path), 2, (50, 70), 3)
    paths = [os.path.join(tmp_path, f"img{i}.png") for i in range(2)]
    arr = np.asarray(Image.open(paths[0]))
    np.save(os.path.join(tmp_path, "img0.npy"), arr)
    for size in (32, 64):
        ours, theirs = BaseImageDataset(paths, size), JaxDataset(paths, size)
        for i in range(2):
            for seed in range(3):
                got = ours.get(i, np.random.default_rng(seed))["real_images"]
                want = theirs.get(i, np.random.default_rng(seed))["real_images"]
                np.testing.assert_array_equal(got, want)
    npy = BaseImageDataset([os.path.join(tmp_path, "img0.npy")], is_train=False)
    np.testing.assert_array_equal(npy.get(0)["real_images"],
                                  JaxDataset(paths[:1], is_train=False).get(0)["real_images"])
    x = JaxDataset(paths[:1], is_train=False).get(0)["real_images"]
    for seed, rr in ((0, (0.5, 0.5)), (1, (1.5, 1.5))):
        got = random_resize(x, np.random.default_rng(seed), rr)
        want = jax_random_resize(x, np.random.default_rng(seed), rr)
        assert got.shape == want.shape
        steps = np.abs(got - want) * 127.5
        assert np.mean(steps <= 2.01) >= 0.98


def test_loader_batches_do_not_depend_on_threads(tmp_path):
    _write_pngs(str(tmp_path), 5, (40, 40), 4)
    paths = [os.path.join(tmp_path, f"img{i}.png") for i in range(5)]
    a, b = (HostDataLoader(BaseImageDataset(paths, 32), 2, num_workers=n, seed=7)
            for n in (1, 3))
    for x, y in zip(a.epoch_batches(1), b.epoch_batches(1)):
        np.testing.assert_array_equal(x["real_images"], y["real_images"])
        assert x["paths"] == y["paths"]
    assert len(a) == 2
