"""Stage 1_1 of the curriculum on the tiny model: the single-beta RD step
against the JAX package's, and its hand-off to stage 1_2.

(1) The RD step of config/exp1_stage1_1.yaml (HyperpriorCharmVicModel, no
betas: RateLoss on the batch's bpp, MSE, the LPIPS proxy, the VQ-code MSE
and the focal cross-entropy, gamma 2) on the same weights and noise: the
JAX side runs ``DCVICModel.__call__(is_train=True)`` and ``_g_losses``
under one ``jax.jit(jax.value_and_grad(...))`` with its noise draws
recorded (z, then the six y slices), which the port replays. Outputs and
loss terms within atol = rtol = 1e-3, each trained parameter's gradient
within a relative L2 error of 1e-3 (+1e-7), as
``tests/test_torch_train_model.py`` holds the dual-beta step.
(2) The 1_1 -> 1_2 hand-off with ``strict: false``: the keys the port's
``Trainer._partial_restore`` carries equal those the JAX trainer's carries
(flax paths mapped to the port's names by the JAX package's path map).
(3) The two stages through ``tools/train.py`` on synthetic PNGs: stage 1_1
trains, validates once without betas and saves; stage 1_2 boots from its
checkpoint with the shipped knobs, the carried tensors equal to 1_1's and
the beta FiLM at its initialisation, and takes its steps.
"""
import logging
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import torch_threads  # noqa: F401
from helpers import tiny_config
from train_helpers import (TOL, _nchw, _port_layout, check_gradients, flax_template,
                           jax_params, recording, zero_by_construction)

from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import PathMapper, export_state_dict
from dc_vic_tpu.train.losses import build_loss as jax_build_loss
from dc_vic_tpu.train.steps import BetaPolicy as JaxPolicy
from dc_vic_tpu.train.steps import _g_losses as jax_g_losses
from dc_vic_tpu.train.trainer import Trainer as JaxTrainer
from dc_vic_tpu_torch.codec.ops import Noise
from dc_vic_tpu_torch.models import build_comp_model
from dc_vic_tpu_torch.models.convert import load_reference_state_dict
from dc_vic_tpu_torch.tools import train as train_tool
from dc_vic_tpu_torch.train.losses import build_loss
from dc_vic_tpu_torch.train.optim import aux_mask, main_mask
from dc_vic_tpu_torch.train.saver import Saver
from dc_vic_tpu_torch.train.steps import BetaPolicy, rd_losses
from dc_vic_tpu_torch.train.trainer import Trainer
from dc_vic_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 2
# the beta FiLM of the dual-beta ELIC transforms: what stage 1_1 cannot carry
FILM = ("encoder.mlp.", "encoder.beta_ft_list.", "decoder.mlp.", "decoder.beta_ft_list.",
        "decoder.init_fuse.")


def _stage_losses():
    """The loss section of config/exp1_stage1_1.yaml, as the port reads it."""
    opt = load_config(os.path.join(ROOT, "config", "exp1_stage1_1.yaml"), is_train=True)
    return {k: dict(v) for k, v in dict(opt["loss"]).items()}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rd():
    """The JAX stage 1_1 RD loss, its outputs, its draws and its gradients,
    once."""
    mp = pytest.MonkeyPatch()
    cfg = tiny_config(use_beta=False)
    m = jax_build(cfg).module
    params = jax_params(m, cfg)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    losses = {k: jax_build_loss(v) for k, v in _stage_losses().items()}
    policy = JaxPolicy(use_beta=False)
    draws = []
    recording(mp, draws)

    def loss_fn(p, x, key):
        del draws[:]
        out = m.apply(p, x, is_train=True, rng=key)
        total, terms = jax_g_losses(m, losses, out, x, None, None, policy)
        return total, (out, terms, list(draws))

    try:
        (total, (out, terms, got_draws)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params, x, jax.random.PRNGKey(5))
    finally:
        mp.undo()
    port = build_comp_model(cfg, device="cpu").module
    load_reference_state_dict(port, export_state_dict(params))
    return dict(x=x, total=float(total), out=jax.tree.map(np.asarray, out),
                terms=jax.tree.map(float, terms), draws=[np.asarray(d) for d in got_draws],
                grads=export_state_dict(grads), port=port)


def _port_step(rd):
    port = rd["port"]
    names = [n for n, _ in port.named_parameters()]
    train, aux = main_mask(names), aux_mask(names)
    for n, p in port.named_parameters():
        p.requires_grad_(train[n] or aux[n])
        p.grad = None
    losses = {k: build_loss(v) for k, v in _stage_losses().items()}
    noise = Noise(draws=[_port_layout(d) for d in rd["draws"]])
    total, terms, out = rd_losses(port, losses, _nchw(rd["x"]), None, None,
                                  BetaPolicy(use_beta=False), noise)
    total.backward()
    return out, dict(terms, total=total), train


def test_stage1_1_losses_are_the_config_s():
    """The five loss terms of config/exp1_stage1_1.yaml, built by the port
    with the JAX package's weights; the rate term is unweighted."""
    cfg = _stage_losses()
    assert sorted(cfg) == ["code_ce_loss", "code_distortion_loss", "distortion_loss",
                           "perceptual_loss", "rate_loss"]
    for name, c in cfg.items():
        ours, theirs = build_loss(c), jax_build_loss(c)
        assert ours.loss_weight == theirs.loss_weight, name
    assert build_loss(cfg["code_ce_loss"]).gamma == 2.0
    assert cfg["rate_loss"].get("reduction", "mean") == "mean"


def test_stage1_1_rd_step_matches_jax(rd):
    """Outputs and loss terms of the replayed step, then every trained
    parameter's gradient against jax.grad; frozen ones get none."""
    out, terms, train = _port_step(rd)
    assert len(rd["draws"]) == 7                       # z, then six y slices
    want = rd["out"]
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(nhwc(out["fake_images"]), want["fake_images"], **TOL)
    np.testing.assert_allclose(nhwc(out["out_vq_logits"]), want["out_vq_logits"], **TOL)
    for key in ("bpp", "qbpp", "vq_accuracy"):
        np.testing.assert_allclose(out[key].detach().numpy(), want[key], **TOL, err_msg=key)
    assert sorted(terms) == sorted(list(rd["terms"]) + ["total"])
    for k, v in rd["terms"].items():
        np.testing.assert_allclose(float(terms[k].detach()), v, **TOL, err_msg=k)
    np.testing.assert_allclose(float(terms["total"].detach()), rd["total"], **TOL)
    port = rd["port"]
    checked = check_gradients(port, rd["grads"], train, zero_by_construction(port))
    assert checked == sum(train.values())


def _carried(target, raw):
    """The keys ``Trainer._partial_restore`` takes from ``raw``."""
    merged = Trainer._partial_restore(target, raw, logging.getLogger("t"), "unit")
    return {k for k in target if merged[k] is raw.get(k)}


def test_handoff_carries_the_jax_trainer_s_keys():
    """1_1 -> 1_2 with strict false: the JAX _partial_restore on the two
    flax parameter trees and the port's on the two state dicts carry the
    same keys; what is left is the beta FiLM."""
    trees = {}
    for use_beta in (False, True):
        cfg = tiny_config(use_beta=use_beta)
        template = flax_template(jax_build(cfg).module, cfg)
        trees[use_beta] = jax.tree.map(lambda t: np.full(t.shape, len(t.shape), np.float32),
                                       template)
    tagged = jax.tree.map(lambda a: a + 1.0, trees[False])
    merged = JaxTrainer._partial_restore(trees[True], tagged, logging.getLogger("t"), "unit")
    mapper = PathMapper()
    want = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(merged)[0]:
        if (np.asarray(leaf) == len(leaf.shape) + 1).all():
            want.add(mapper.map_path(tuple(k.key for k in path))[0])
    s11 = build_comp_model(tiny_config(use_beta=False), device="cpu").module.state_dict()
    s12 = build_comp_model(tiny_config(use_beta=True), device="cpu").module.state_dict()
    got = _carried(s12, s11)
    assert got == want
    assert got == set(s11) and not any(k.startswith(FILM) for k in got)
    assert {k for k in s12 if k not in got} == {k for k in s12 if k.startswith(FILM)}


def _write_pngs(root, n, size, seed):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(
            os.path.join(root, f"img{i}.png"))


def _stage_yaml(tmp, stage, use_beta, load):
    """config/exp1_stage{stage}.yaml at the tiny widths on the synthetic
    data, ITERS iterations, saving and validating at the last."""
    cfg = {
        "_base_": os.path.join(ROOT, "config", f"exp1_stage{stage}.yaml"),
        "subnet": dict(tiny_config(use_beta=use_beta).to_plain()["subnet"], _delete_=True),
        "ckpt_root": os.path.join(tmp, "ckpt"), "seed": 0,
        "total_iter": ITERS, "log_step": 1, "eval_step": ITERS, "save_step": ITERS,
        "keep_step": [ITERS],
        "dataset": {"batch_size": 2,
                    "train_dataset": {"root_dir": os.path.join(tmp, "data"),
                                      "subset_list": [0], "image_size": 64},
                    "eval_dataset": {"root_dir": os.path.join(tmp, "data", "kodak")}},
        "load_checkpoint": dict(load, _delete_=True) if load else None,
    }
    path = os.path.join(tmp, f"exp1_stage{stage}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_stage1_1_trains_and_stage1_2_boots_from_it(tmp_path):
    tmp = str(tmp_path)
    _write_pngs(os.path.join(tmp, "data", "train_0"), 4, (72, 80), 0)
    _write_pngs(os.path.join(tmp, "data", "kodak"), 1, (64, 96), 1)
    t11 = train_tool.main(["--config_path", _stage_yaml(tmp, "1_1", False, None),
                           "--device", "cpu"])
    assert type(t11).__name__ == "Trainer" and not t11.model.use_beta
    assert t11.policy.sample(t11.state.generator, 2) == (None, None)
    model_dir = os.path.join(tmp, "ckpt", "exp1_stage1_1", "model")
    ckpt = os.path.join(model_dir, f"comp_model_iter{ITERS}.ckpt")
    saved = Saver.load(ckpt)
    with open(os.path.join(tmp, "ckpt", "exp1_stage1_1", "eval_result.csv")) as f:
        rows = f.read().strip().splitlines()
    assert len(rows) == 2 and rows[1].split(",")[1:3] == ["", ""]
    assert all(np.isfinite(float(x)) for x in rows[1].split(",")[3:])
    # the shipped 1_2 knobs: weights only, partial restore, schedule reset
    load = {"path": ckpt, "load_optimizer": False, "load_scheduler": False, "strict": False}
    path12 = _stage_yaml(tmp, "1_2", True, load)
    t12 = train_tool.main(["--config_path", path12, "--device", "cpu", "dry_run=true"])
    fresh = train_tool.build_trainer(load_config(
        _stage_yaml(tmp, "1_2", True, None), overrides=["dry_run=true"], is_train=True),
        device="cpu")
    booted, init = t12.model.state_dict(), fresh.model.state_dict()
    for k, v in booted.items():
        if k.startswith(FILM):
            assert torch.equal(v, init[k]), k
        else:
            assert torch.equal(v, saved[k]), k
    assert any(not torch.equal(saved[k], init[k]) for k in saved if k.startswith("encoder."))
    t12.train_loop()
    assert os.path.exists(os.path.join(tmp, "ckpt", "exp1_stage1_2", "model",
                                       f"comp_model_iter{ITERS}.ckpt"))
