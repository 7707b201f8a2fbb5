"""Data-parallel training on the CPU: two ranks joined by gloo (a file
store, so parallel test workers never share a port) against one process,
and against the JAX package's ``data_parallel_step`` on a 2-device mesh.

* The port's 2-rank steps (stage 1_2's RD step, stage 1_3's GAN step with
  ``mc_sampling``, both through ``build_trainer(..., dp=...)`` on the tiny
  config) against the 1-process trainer on the same global batch. The
  ranks draw the betas and the noise for the global batch from the same
  seeded generator and slice them, so the draws are the 1-process step's.
  Held: the loss terms at ``train_helpers.TOL``, every gradient an
  optimizer used at ``GRAD_TOL`` relative L2 (the biases that are zero by
  construction below ``GRAD_TOL`` of their weight's gradient), the
  parameters after the step at ``TOL``; the two ranks' parameters,
  buffers and optimizer states bit-equal.
* A non-finite image on one rank only: both ranks skip the step.
* The 2-rank stage 1_1 RD step against the JAX ``data_parallel_step(
  make_rd_step(...), make_mesh(2))`` (jitted once, the noise draws of its
  forward recorded at their call sites and returned by the step), on the
  weights ``train_helpers.jax_params`` carries, each rank replaying its
  slice of the global draws: the terms and the trained tensors after the
  step at ``TOL``, and the gradients the optimizers averaged, read from
  both packages' Adam first moments (one step from zero: 0.1 times the
  clipped gradient), at ``GRAD_TOL`` relative L2.
* The launcher: ``tools/train.py --nproc 2 --device cpu`` trains two steps,
  rank 0 alone writing the CSVs and one checkpoint, which boots a 1-rank
  trainer; a 1-rank checkpoint boots the 2-rank stage 1_3 trainers with the
  keys a 1-rank boot carries.
"""
import csv
import os

import numpy as np
import pytest
import torch

import dp_workers
import torch_threads  # noqa: F401
from helpers import tiny_config
from train_helpers import DP_WORLD as WORLD
from train_helpers import GRAD_TOL, TOL, jax_dp_step, stage_yaml, zero_by_construction

from dc_vic_tpu_torch.models import build_comp_model
from dc_vic_tpu_torch.tools import train as train_tool
from dc_vic_tpu_torch.train.saver import Saver
from dc_vic_tpu_torch.train.trainer import build_trainer
from dc_vic_tpu_torch.utils.config import load_config


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 2-rank job, and meanwhile the 1-process references and the JAX
    step, whose draws the ranks replay last."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    dp_workers.write_images(os.path.join(tmp, "data", "train_0"), 8, (72, 80), 0)
    dp_workers.write_images(os.path.join(tmp, "data", "kodak"), 1, (64, 96), 1)
    rd_yaml = stage_yaml(tmp, "1_2")
    # the stage 1_2 checkpoint both stage 1_3 trainers boot from: one
    # process's weights at init
    ckpt = build_trainer(load_config(rd_yaml, is_train=True), device="cpu").save(0)[0]
    gan_yaml = stage_yaml(tmp, "1_3", dict(path=ckpt, load_optimizer=False, strict=False),
                           trainer={"mc_sampling": True})
    out, case = os.path.join(tmp, "out"), os.path.join(tmp, "jax_case.pt")
    os.makedirs(out)
    job = dp_workers.spawn(dp_workers.trainer_ranks, WORLD, os.path.join(tmp, "store"),
                           {"rd": rd_yaml, "gan": gan_yaml}, case, out,
                           1)
    one = {}
    try:
        for kind, path in (("rd", rd_yaml), ("gan", gan_yaml)):
            tr = build_trainer(load_config(path, is_train=True), device="cpu")
            one[kind] = dp_workers.taken(tr, tr.step(dp_workers.first_batch(tr)))
        del tr
        jax_side = jax_dp_step(case)
    finally:
        if not os.path.exists(case):
            open(case + ".failed", "w").close()
        while not job.join():
            pass
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    module = build_comp_model(tiny_config(), device="cpu").module
    return dict(one=one, ranks=ranks, jax=jax_side, zero=zero_by_construction(module),
                tmp=tmp)


def _hold_grads(got, want, zero, label):
    """Each gradient against the 1-process one (relative L2 GRAD_TOL + 1e-7;
    a bias in ``zero`` below GRAD_TOL of its weight's gradient instead)."""
    assert set(got) <= set(want) and (label.startswith("JAX") or set(got) == set(want)), label
    for n, g in got.items():
        w = want[n]
        if n in zero:
            scale = float(torch.linalg.vector_norm(want[n[:-len("bias")] + "weight"]))
            assert max(float(torch.linalg.vector_norm(g)),
                       float(torch.linalg.vector_norm(w))) <= GRAD_TOL * scale, n
            continue
        err = float(torch.linalg.vector_norm(g - w))
        ref = float(torch.linalg.vector_norm(w))
        assert err <= GRAD_TOL * ref + 1e-7, f"{label} {n}: relative L2 error {err / ref:.3e}"


@pytest.mark.parametrize("kind", ["rd", "gan"])
def test_two_rank_step_matches_one_process(runs, kind):
    """Terms, gradients (G, and D in the GAN step) and weights after the
    step of each rank against the 1-process step on the global batch."""
    want = runs["one"][kind]
    assert want["terms"]["skipped"] == 0.0
    for r, rank in enumerate(runs["ranks"]):
        got = rank[kind]
        assert set(got["terms"]) == set(want["terms"])
        for k, v in want["terms"].items():
            np.testing.assert_allclose(got["terms"][k], v, **TOL, err_msg=f"rank {r}: {k}")
        _hold_grads(got["grads"], want["grads"], runs["zero"], f"{kind} rank {r}")
        if kind == "gan":
            _hold_grads(got["disc_grads"], want["disc_grads"], set(), f"D rank {r}")
        for k, v in want["model"].items():
            np.testing.assert_allclose(got["model"][k].numpy(), v.numpy(), **TOL,
                                       err_msg=f"rank {r}: {k}")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


@pytest.mark.parametrize("kind", ["rd", "gan", "skip"])
def test_ranks_stay_bit_equal(runs, kind):
    """After the step both ranks hold the same bits: parameters, buffers,
    the discriminator and every optimizer state; the terms are one mean."""
    a, b = (rank[kind] for rank in runs["ranks"])
    assert a["terms"].keys() == b["terms"].keys()
    np.testing.assert_array_equal(list(a["terms"].values()), list(b["terms"].values()))
    for key in ("model", "opts", "disc"):
        pairs = list(zip(_flat(a.get(key, {})), _flat(b.get(key, {}))))
        assert pairs or key == "disc"
        for (na, ta), (nb, tb) in pairs:
            assert na == nb and torch.equal(ta, tb), f"{kind}: {na} differs between ranks"


def test_nonfinite_image_on_one_rank_skips_both(runs):
    """Rank 1's batch holds a NaN pixel: both ranks read the mean loss as
    non-finite, skip, and keep the weights and the optimizer states of the
    step before; the step counts advance everywhere."""
    for rank in runs["ranks"]:
        assert rank["skip"]["terms"]["skipped"] == 1.0
        assert not np.isfinite(rank["skip"]["terms"]["total"])
        for (n, before), (_, after) in zip(_flat(rank["rd"]["model"]),
                                           _flat(rank["skip"]["model"])):
            assert torch.equal(before, after), n
        for opt in ("g_opt", "aux_opt"):
            for (n, before), (_, after) in zip(_flat(rank["rd"]["opts"][opt]),
                                               _flat(rank["skip"]["opts"][opt])):
                assert torch.equal(before, after), f"{opt}.{n}"


def test_two_rank_step_matches_jax_data_parallel_step(runs):
    """The 2-rank stage 1_1 RD step against the JAX mesh step: the terms,
    the averaged gradients (Adam's first moments) of every tensor the main
    and aux optimizers train, and the weights after the step."""
    want = runs["jax"]
    assert want["n_draws"] == 7                       # z, then six y slices
    for r, rank in enumerate(runs["ranks"]):
        got = rank["jax"]
        assert got["terms"]["skipped"] == want["terms"]["skipped"] == 0.0
        for k, v in want["terms"].items():
            np.testing.assert_allclose(got["terms"][k], v, **TOL, err_msg=f"rank {r}: {k}")
        mu = {**got["opts"]["g_opt"]["mu"], **got["opts"]["aux_opt"]["mu"]}
        assert "entropy_model_z.quantiles" in mu and len(mu) > 100
        _hold_grads(mu, {n: torch.from_numpy(np.array(want["mu"][n]).reshape(t.shape))
                         for n, t in mu.items()}, runs["zero"], f"JAX, rank {r}")
        for n, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), np.asarray(want["end"][n]).reshape(p.shape),
                                       **TOL, err_msg=f"rank {r}: {n}")


def test_one_rank_checkpoint_boots_two_ranks(runs):
    """Stage 1_3's 2-rank trainers booted from a 1-process stage 1_2
    checkpoint carry the keys a 1-process boot carries."""
    want = runs["one"]["gan"]["restored"]
    assert want["carried"] and not want["strict"]
    for rank in runs["ranks"]:
        assert rank["gan"]["restored"] == want


def test_launcher_two_ranks_writes_once_and_boots_one(runs, tmp_path):
    """``tools/train.py --nproc 2 --device cpu``: two steps, one loss row a
    step and one checkpoint, written by rank 0; that checkpoint boots a
    1-process trainer strictly, keys and bits."""
    tmp = runs["tmp"]
    path = stage_yaml(tmp, "1_2", exp="launch", total_iter=2, log_step=1, eval_step=2,
                       save_step=2, keep_step=[2])
    assert train_tool.main(["--config_path", path, "--device", "cpu", "--nproc", "2"]) is None
    job = os.path.join(tmp, "ckpt", "launch")
    with open(os.path.join(job, "log_loss.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["iter"] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(r["total"])) and r["skipped"] == "0.0" for r in rows)
    with open(os.path.join(job, "eval_result.csv")) as f:
        assert [r["iter"] for r in csv.DictReader(f)] == ["2"] * 4
    ckpts = sorted(os.listdir(os.path.join(job, "model")))
    assert ckpts == ["comp_model_iter2.ckpt", "training_state_iter2.ckpt"]
    saved = Saver.load(os.path.join(job, "model", "comp_model_iter2.ckpt"))
    boot = stage_yaml(tmp, "1_2", dict(path=os.path.join(job, "model", "comp_model_iter2.ckpt"),
                                        training_state_path=os.path.join(
                                            job, "model", "training_state_iter2.ckpt"),
                                        strict=True), exp="boot")
    tr = build_trainer(load_config(boot, is_train=True), device="cpu")
    assert tr.restored["strict"] and tr.restored["optimizer"]
    assert sorted(tr.restored["carried"]) == sorted(saved)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert int(tr.state.g_opt.count) == 2
