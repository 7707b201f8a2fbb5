"""Fully sharded training (FSDP) and the sharded eval sweep on the CPU: two
ranks joined by gloo (a file store) in one spawn for the whole module, each
running the data-parallel step and the FSDP step (``fsdp: true``) of the
tiny config, shards from ``MIN_SIZE`` elements (as tests/test_train.py's
FSDP test shards the tiny JAX state), while the parent runs the JAX FSDP
step and the JAX eval sweep.

* ``fsdp_plan`` shards the same tensors as the JAX ``fsdp_sharding_tree`` on
  the same carried weights; the dimension follows the rule on the port's
  own layout.
* The FSDP stage 1_2 RD step and stage 1_3 GAN step (``mc_sampling``)
  against the data-parallel step of the same ranks from the same start:
  the terms at ``TOL``, the weights and the optimizer moments at the JAX
  FSDP test's rtol 2e-4 / atol 2e-5; the RD step's gradient norm is over
  ``clip_max_norm``, so the clip, summed over the ranks' slices, is held.
* The FSDP stage 1_1 RD step against the JAX ``data_parallel_step`` with
  ``state_shardings=fsdp_sharding_tree(...)`` on a 2-device mesh, its noise
  draws replayed: terms, Adam first moments and weights.
* Between steps a rank holds its slices of the sharded tensors and of their
  moments, and the other tensors whole; a non-finite image on one rank
  makes both skip with every slice unchanged.
* Checkpoints cross both ways: a 1-process checkpoint boots the FSDP ranks
  bit for bit, and the FSDP ranks' save (a gather on every rank) boots one
  process bit for bit.
* ``data_parallel_eval`` on ``["cpu", "cpu"]`` against the JAX
  ``data_parallel_eval`` on ``make_mesh(2)`` and against one device; a batch
  that does not divide raises.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dp_workers
import torch_threads  # noqa: F401
from helpers import tiny_config
from train_helpers import DP_WORLD as WORLD
from train_helpers import GRAD_TOL, TOL, jax_dp_step, stage_yaml

from dc_vic_tpu.parallel.mesh import data_parallel_eval as jax_data_parallel_eval
from dc_vic_tpu.parallel.mesh import make_mesh as jax_mesh
from dc_vic_tpu_torch.models import build_comp_model
from dc_vic_tpu_torch.models.convert import load_reference_state_dict
from dc_vic_tpu_torch.parallel import data_parallel_eval, fsdp_plan
from dc_vic_tpu_torch.train.saver import Saver
from dc_vic_tpu_torch.train.trainer import build_trainer
from dc_vic_tpu_torch.utils.config import load_config
from dc_vic_tpu_torch.utils.paths import PathHandler

MIN_SIZE = 1 << 8
FSDP_TOL = dict(rtol=2e-4, atol=2e-5)     # tests/test_train.py's FSDP against replicated
CLIP = 1.0                                # config/exp1_stage1_2.yaml's clip_max_norm
# the model of the JAX comparisons: the tiny stage 1_1 model's type without
# ChARM, whose JAX FSDP step traces and loads from the compilation cache in
# about two thirds of the ChARM model's time (the ChARM model's step is held
# against the JAX data-parallel step in tests/test_torch_train_dp.py)
JAX_CHARM = False


def _eval_case(m, params):
    """A batch of four images in [-1, 1] and the JAX ``data_parallel_eval``
    of ``vq_encode`` (the model ``m`` on ``params``) over a 2-device mesh."""
    x = np.random.default_rng(5).uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    fn = jax_data_parallel_eval(lambda p, b: m.apply(p, b, method=m.vq_encode), jax_mesh(WORLD))
    lat, idx = fn(params, jnp.asarray(x))
    return dict(x=x, latent=np.asarray(lat), indices=np.asarray(idx))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One 2-rank job, and meanwhile the JAX FSDP step (whose draws the
    ranks replay last) and the JAX eval sweep."""
    tmp = str(tmp_path_factory.mktemp("fsdp"))
    dp_workers.write_images(os.path.join(tmp, "data", "train_0"), 8, (72, 80), 0)
    dp_workers.write_images(os.path.join(tmp, "data", "kodak"), 1, (64, 96), 1)
    # the checkpoint the ranks boot from: one process after one step (so
    # the optimizer moments it carries are not zero), made by rank 0 first
    yamls = {"one": stage_yaml(tmp, "1_2", exp="one")}
    ph = PathHandler(os.path.join(tmp, "ckpt"), "one")
    model_ckpt, state_ckpt = (ph.checkpoint_path(k, 1) for k in ("comp_model", "training_state"))
    rd = dict(path=model_ckpt, training_state_path=state_ckpt, strict=True)
    gan = dict(path=model_ckpt, load_optimizer=False, strict=False)
    for mode in ("dp", "fsdp"):
        extra = {"fsdp": True} if mode == "fsdp" else {}
        yamls["rd", mode] = stage_yaml(tmp, "1_2", rd, exp=f"rd_{mode}", **extra)
        yamls["gan", mode] = stage_yaml(tmp, "1_3", gan, exp=f"gan_{mode}",
                                        trainer={"mc_sampling": True}, **extra)
    out, case = os.path.join(tmp, "out"), os.path.join(tmp, "jax_case.pt")
    os.makedirs(out)
    job = dp_workers.spawn(dp_workers.fsdp_ranks, WORLD, os.path.join(tmp, "store"), yamls,
                           case, out, 1, MIN_SIZE)
    try:
        jax_side = jax_dp_step(case, fsdp_min_size=MIN_SIZE, use_charm=JAX_CHARM)
        eval_case = _eval_case(jax_side["module"], jax_side["params"])
    finally:
        if not os.path.exists(case):
            open(case + ".failed", "w").close()
        while not job.join():
            pass
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    assert ranks[0]["one"] == [model_ckpt, state_ckpt]
    return dict(ranks=ranks, jax=jax_side, eval=eval_case, tmp=tmp,
                boot=dict(comp_model=Saver.load(model_ckpt),
                          training_state=Saver.load(state_ckpt)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree


def _hold(got, want, label, **tol):
    """Every tensor of ``want`` (a nested dict) in ``got``, at ``tol`` or
    bit for bit without one."""
    got = dict(_flat(got))
    pairs = list(_flat(want))
    assert pairs and {n for n, _ in pairs} == set(got), label
    for n, w in pairs:
        if tol:
            np.testing.assert_allclose(got[n].numpy(), w.numpy(), **tol, err_msg=f"{label}: {n}")
        else:
            assert torch.equal(got[n], w), f"{label}: {n} differs"


def test_fsdp_plan_shards_what_jax_shards(runs):
    """The tensors ``fsdp_plan`` shards in the stage 1_1 model are those the
    JAX ``fsdp_sharding_tree`` shards in the same weights at the same
    ``min_size``; each on its largest dimension that divides by the world,
    the first of equal ones."""
    module = build_comp_model(tiny_config(use_charm=JAX_CHARM, use_beta=False), device="cpu").module
    named = dict(module.named_parameters())
    plan = fsdp_plan(named, WORLD, MIN_SIZE)
    sharded = {n for n, d in plan.items() if d is not None}
    assert sharded and sharded != set(named)
    assert sharded == set(runs["jax"]["sharded"])
    for n, p in named.items():
        fits = [d for d, s in enumerate(p.shape) if s % WORLD == 0]
        want = (max(fits, key=lambda d: (p.shape[d], -d))
                if fits and p.numel() >= MIN_SIZE else None)
        assert plan[n] == want, n


@pytest.mark.parametrize("shape, world, want", [
    ((64, 64, 3, 3), 2, 0),          # a tie: the first of the equal dimensions
    ((3, 128, 5, 5), 2, 1),          # the largest that divides
    ((96, 128, 1, 1), 3, 0),         # 128 does not divide by 3
    ((5, 7, 9, 11), 2, None),        # none divides
    ((8, 8, 1, 1), 2, None),         # under min_size
])
def test_fsdp_plan_rule(shape, world, want):
    assert fsdp_plan({"w": torch.empty(shape)}, world, MIN_SIZE)["w"] == want


@pytest.mark.parametrize("kind", ["rd", "gan"])
def test_fsdp_step_matches_data_parallel_step(runs, kind):
    """Terms, weights (the model's and D's) and optimizer moments of each
    rank's FSDP step against its data-parallel step from the same start."""
    for r, rank in enumerate(runs["ranks"]):
        got, want = rank[kind, "fsdp"], rank[kind, "dp"]
        assert want["terms"]["skipped"] == got["terms"]["skipped"] == 0.0
        assert set(got["terms"]) == set(want["terms"])
        for k, v in want["terms"].items():
            np.testing.assert_allclose(got["terms"][k], v, **TOL, err_msg=f"rank {r}: {k}")
        for label in ("comp_model", "discriminator", "training_state"):
            if label in want:
                _hold(got[label], want[label], f"{kind} rank {r} {label}", **FSDP_TOL)


def test_clip_holds_over_the_ranks_slices(runs):
    """The RD step's gradients are clipped (their global norm exceeds
    ``clip_max_norm``), and the moments taken from the clipped gradients
    match the data-parallel step's: the norm sums the slices over the ranks
    and counts the whole tensors once."""
    for r, rank in enumerate(runs["ranks"]):
        assert rank["rd", "grad_norm"] > 10 * CLIP, rank["rd", "grad_norm"]
        got, want = rank["rd", "fsdp"], rank["rd", "dp"]
        for moment in ("mu", "nu"):
            _hold(got["training_state"]["g_opt"][moment], want["training_state"]["g_opt"][moment],
                  f"rank {r} g_opt.{moment}", **FSDP_TOL)


@pytest.mark.parametrize("kind", ["rd", "gan"])
def test_ranks_agree_after_the_step(runs, kind):
    """The whole tensors gathered on either rank are the same bits."""
    a, b = (rank[kind, "fsdp"] for rank in runs["ranks"])
    assert a["terms"] == b["terms"]
    _hold(a, {k: v for k, v in b.items() if k != "terms"}, f"{kind}: rank 0 against rank 1")


def test_fsdp_step_matches_jax_fsdp_step(runs):
    """The FSDP stage 1_1 RD step against the JAX mesh step with the state
    sharded by ``fsdp_sharding_tree``: the terms, the averaged gradients
    (Adam's first moments after one step) and the weights after the step."""
    want = runs["jax"]
    assert want["n_draws"] == 2                       # z, then y (no ChARM slices)
    for r, rank in enumerate(runs["ranks"]):
        got = rank["jax"]
        assert got["terms"]["skipped"] == want["terms"]["skipped"] == 0.0
        for k, v in want["terms"].items():
            np.testing.assert_allclose(got["terms"][k], v, **TOL, err_msg=f"rank {r}: {k}")
        mu = {**got["opts"]["g_opt"]["mu"], **got["opts"]["aux_opt"]["mu"]}
        assert "entropy_model_z.quantiles" in mu and len(mu) > 100
        for n, g in mu.items():
            w = torch.from_numpy(np.array(want["mu"][n]).reshape(g.shape))
            err, ref = float(torch.linalg.vector_norm(g - w)), float(torch.linalg.vector_norm(w))
            assert err <= GRAD_TOL * ref + 1e-7, f"rank {r} {n}: relative L2 {err / ref:.3e}"
        for n, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), np.asarray(want["end"][n]).reshape(p.shape),
                                       **TOL, err_msg=f"rank {r}: {n}")


@pytest.mark.parametrize("when", [("rd", "rest"), ("gan", "rest"), ("skip", "rest")])
def test_between_steps_a_rank_holds_its_slices(runs, when):
    """After a step every sharded parameter and each of its moments holds
    1/world of its elements on a rank, and every other tensor is whole."""
    for rank in runs["ranks"]:
        held = rank[when]
        sharded = {n for n, (_, _, d) in held.items() if d is not None}
        assert sharded and len(sharded) < len(held)
        for n, (count, shape, d) in held.items():
            whole = int(np.prod(shape))
            assert count == (whole // WORLD if d is not None else whole), n


def test_nonfinite_image_on_one_rank_skips_both(runs):
    """Rank 1's batch holds a NaN pixel: both ranks skip, and every slice of
    the weights and the optimizer states is as it was."""
    for rank in runs["ranks"]:
        assert rank["skip"]["terms"]["skipped"] == 1.0
        before, after = rank["rd", "fsdp"], rank["skip"]
        _hold(after["comp_model"], before["comp_model"], "skip: model")
        for opt in ("g_opt", "aux_opt"):
            _hold(after["training_state"][opt], before["training_state"][opt], f"skip: {opt}")
        assert after["training_state"]["step"] == before["training_state"]["step"] + 1


def test_one_process_checkpoint_boots_fsdp_ranks(runs):
    """The FSDP ranks booted from a 1-process checkpoint (model and
    optimizer states) hold its bits, gathered whole."""
    want = runs["boot"]
    for r, rank in enumerate(runs["ranks"]):
        boot = rank["rd", "boot"]
        _hold(boot["comp_model"], want["comp_model"], f"rank {r} model")
        for opt in ("g_opt", "aux_opt"):
            _hold(boot["training_state"][opt], want["training_state"][opt], f"rank {r} {opt}")


def test_fsdp_checkpoint_boots_one_process(runs):
    """The FSDP ranks' save (rank 0 writes what every rank gathered) boots a
    1-process trainer strictly, weights and optimizer states bit for bit;
    the validation before it ran on rank 0 alone."""
    ranks = runs["ranks"]
    paths = ranks[0]["saved"]
    assert ranks[1]["saved"] is None and ranks[1]["validate"] == {}
    assert ranks[0]["validate"] and all(np.isfinite(v) for v in ranks[0]["validate"].values())
    tr = build_trainer(load_config(stage_yaml(
        runs["tmp"], "1_2", dict(path=paths[0], training_state_path=paths[1], strict=True),
        exp="boot_one"), is_train=True), device="cpu")
    assert tr.restored["strict"] and tr.restored["optimizer"]
    got = dp_workers.snapshot(tr)
    want = ranks[0]["skip"]
    _hold(got["comp_model"], want["comp_model"], "model")
    for opt in ("g_opt", "aux_opt"):
        _hold(got["training_state"][opt], want["training_state"][opt], opt)


def test_data_parallel_eval_matches_jax_and_one_device(runs):
    """``data_parallel_eval`` of ``vq_encode`` over ``["cpu", "cpu"]``: the
    latents and indices of the JAX sweep on a 2-device mesh, and those of
    one call on the whole batch; a batch of 3 over 2 entries raises."""
    case = runs["eval"]
    module = build_comp_model(tiny_config(use_charm=JAX_CHARM, use_beta=False), device="cpu").module.eval()
    load_reference_state_dict(module, runs["jax"]["start"])
    x = torch.from_numpy(case["x"]).permute(0, 3, 1, 2).contiguous()
    sweep = data_parallel_eval(lambda m, b: m.vq_encode(b), ["cpu", "cpu"])
    with torch.no_grad():
        lat, idx = sweep(module, x)
        one_lat, one_idx = module.vq_encode(x)
    np.testing.assert_allclose(lat.permute(0, 2, 3, 1).numpy(), case["latent"], **TOL)
    np.testing.assert_array_equal(idx.numpy(), case["indices"])
    assert torch.equal(lat, one_lat) and torch.equal(idx, one_idx)
    with pytest.raises(ValueError, match="does not divide"):
        sweep(module, x[:3])
