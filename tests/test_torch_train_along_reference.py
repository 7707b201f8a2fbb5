"""One training step of the port from states the JAX trainer's own run has
reached, against the JAX step from the same state.

The JAX side is ``dc_vic_tpu/train/steps.py``'s RD and GAN steps, each
jitted once, run from a seeded init (the port's ``init_weights``, which
draws from the JAX init's laws, carried into flax) on numpy batches
(2 x 64 x 64, uniform in [-1, 1]). At chosen steps (snapshots) its whole
training state is carried into a fresh port model and fresh optimizers
(``models/convert.py::load_reference_state_dict`` and
``load_reference_optimizer_state``, optax's Adam state read by
``train_helpers.optax_adam_state``), and the port takes that step with the
JAX step's batch, noise draws (recorded inside the jitted step by
``train_helpers.recording``, replayed through ``codec.ops.Noise``) and
betas (replayed through the policy's ``sample``).

* Stage 1_1 (``tiny_config(use_beta=False)``, config/exp1_stage1_1.yaml's
  losses and clip, aux Adam 1e-3) with the soak's main optimizer: Adam
  under a ``LinearWarmupScheduler`` of 16 steps from a tenth, at a base
  rate of 1e-3 (ten times the config's, so that 32 steps move the
  weights, the moments and the quantiles). Snapshots after 0, 8 (in the
  warm-up), 16 (its end) and 32 (past it) steps; each holds the next step.
* Stage 1_2 (``tiny_config()``, config/exp1_stage1_2.yaml, main rate 1e-3,
  per-sample dual betas): the step after 8 steps.
* Stage 1_3 (``tiny_config()``, config/exp1_stage1_3.yaml's losses, main
  and discriminator Adam at 1e-3, a small
  ``DualBetaCondTamingNLayerDiscriminator``): the step after 8 GAN steps,
  the discriminator and its Adam state carried as well.

The stages' JAX runs are independent (each from its model's seeded init,
on its own batches); stages 1_2 and 1_3 run in spawned processes while
the test's process runs stage 1_1, since each run spends most of its time
tracing its step on one core.

Held at every snapshot (``train_helpers.step_ratios``): every loss term
(atol = rtol = 1e-3, the single-step tests'); the update of every trained
tensor (relative L2 ``MOTION_TOL`` = 1e-3 of the JAX update, + 1e-7) and
both Adam moments after the step (relative L2 1e-3); the biases whose
gradient is zero by construction (``train_helpers.zero_by_construction``)
instead within the step's rate, and their moments within 1e-3 of their
weight's, in both packages; the quantiles after the step (TOL); both
optimizers' counts and the rate the schedule gives. Where the estimator's
argmax or a rounding of y comes out differently in the two packages the
count is printed: a flip that moves no held term is rounding at a tie.

Besides, the optimizer state carries into the port and back bit for bit.
"""
import concurrent.futures
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from helpers import tiny_config
from train_helpers import (_nchw, _port_layout, carried_optimizers, export_discriminator,
                           optax_adam_state, recording, step_ratios, zero_by_construction)

from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import convert_state_dict, export_state_dict
from dc_vic_tpu.models.discriminators import DualBetaCondTamingNLayerDiscriminator
from dc_vic_tpu.train import optim as jax_optim
from dc_vic_tpu.train.losses import build_loss as jax_build_loss
from dc_vic_tpu.train.steps import BetaPolicy as JaxPolicy
from dc_vic_tpu.train.steps import TrainState as JaxState
from dc_vic_tpu.train.steps import make_gan_step, make_rd_step
from dc_vic_tpu_torch.codec.ops import Noise
from dc_vic_tpu_torch.models import build_comp_model, init_weights
from dc_vic_tpu_torch.models import discriminators as port_disc
from dc_vic_tpu_torch.models.convert import (load_reference_optimizer_state,
                                             load_reference_state_dict)
from dc_vic_tpu_torch.train import steps as port_steps
from dc_vic_tpu_torch.train.losses import build_loss
from dc_vic_tpu_torch.train.optim import aux_mask, build_optimizer, main_mask, masked_params
from dc_vic_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOTS = (0, 8, 16, 32)         # stage 1_1: the steps taken before the held one
MOVED = 8                          # stages 1_2 and 1_3: the same
LR = 1e-3                          # the main optimizers' base rate
WARMUP = {"type": "LinearWarmupScheduler", "warmup_iters": 16, "warmup_factor": 0.1}
DISC = dict(ndf=8, n_layers=2, cond_ch=4, L=4, norm_type="none", max_beta_1=3.0,
            max_beta_2=3.5)
BATCH = 2


def _stage(stage):
    """A stage config's losses, optimizers (main rate LR) and beta policy
    (both packages' ``BetaPolicy`` keywords)."""
    opt = load_config(os.path.join(ROOT, "config", f"exp1_stage{stage}.yaml"), is_train=True)
    losses = {k: dict(v) for k, v in dict(opt["loss"]).items()}
    optim = dict(opt["optim"])
    g_opt = dict(optim["g_optimizer"], lr=LR)
    policy = dict(use_beta=stage != "1_1",
                  sample_batch_beta=bool((opt.get("model") or {}).get("sample_batch_beta")),
                  weight_type=(opt.get("model") or {}).get("beta_weight_type", "linear"))
    return dict(losses=losses, clip=optim["clip_max_norm"], g_opt=g_opt,
                g_sched=dict(optim["g_scheduler"]),
                aux_opt=dict(optim.get("aux_optimizer") or {"lr": 1e-3}),
                d_opt=dict(optim.get("d_optimizer") or {}, lr=LR),
                d_sched=dict(optim.get("d_scheduler") or {}), policy=policy)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _recorded(step, module, policy, gan=False):
    """``step`` jitted with what the port needs to replay it and to count
    near-ties: the step's noise draws and betas, and the estimator's
    tokens and the rounded y and z of a forward at the state the step
    starts from, on the step's model key (so with the step's draws). No
    host callback: the executable stays in the compilation cache."""
    draws = []

    def run(state, x):
        del draws[:]
        new, terms = step(state, x)
        _, r_beta, r_model = jax.random.split(state.rng, 3)
        betas = policy.sample(r_beta, x.shape[0])
        got = list(draws)
        out = module.apply(state.params, x, *(b for b in betas if b is not None),
                           is_train=True, rng=r_model, fix_entropy_models=gan)
        return new, terms, dict(draws=got, betas=betas,
                                tokens=jnp.argmax(out["out_vq_logits"], axis=-1),
                                y_hat=out["quantized_code"]["y"],
                                z_hat=out["quantized_code"]["z"])
    mp = pytest.MonkeyPatch()
    recording(mp, draws)
    jitted = jax.jit(run)

    def call(state, x):
        try:
            return jitted(state, x)
        finally:
            mp.undo()
    return call


def _run(call, state, batches, snapshots):
    """The JAX run: ``state`` through ``batches``; for each step taken after
    a snapshot, the state before and after it, its batch, terms and
    recording (all on the host)."""
    held = {}
    for i, x in enumerate(batches):
        new, terms, rec = call(state, jnp.asarray(x))
        if i in snapshots:
            held[i] = dict(before=_host(state), after=_host(new), x=x,
                           terms=jax.tree.map(float, terms), rec=_host(rec))
        state = new
    return held


def _start(g_tx, aux_tx, params, key, d_tx=None, d_params=None):
    """A JAX training state at ``params``, made in one jit (the optimizers'
    eager init compiles an op for each weight)."""
    return jax.jit(lambda p, d: JaxState(
        params=p, g_opt=g_tx.init(p), aux_opt=aux_tx.init(p), step=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(key), d_params=d,
        d_opt=None if d is None else d_tx.init(d)))(params, d_params)


BATCHES = {"1_1": (0, SNAPSHOTS[-1] + 1), "1_2": (40, MOVED + 1), "1_3": (50, MOVED + 1)}
SCHEDULES = {"1_1": WARMUP, "1_2": None, "1_3": None}     # None: the stage config's


def _jax_run(stage: str) -> dict:
    """One stage's JAX run from its model's seeded init, on its slice of the
    batches: the held snapshots."""
    cfg, st = _config(stage), _stage(stage)
    first, n = BATCHES[stage]
    batches = np.random.default_rng(11).uniform(
        -1, 1, (60, BATCH, 64, 64, 3)).astype(np.float32)[first:first + n]
    m = jax_build(cfg).module
    b = (jnp.array([0.0]),) * 2 if m.use_beta else ()
    # the port's seeded init (the JAX init's laws, tests/test_torch_init.py)
    # carried into flax: tracing the flax init costs less than compiling it
    template = jax.eval_shape(lambda r: m.init({"params": r}, jnp.zeros((1, 64, 64, 3)), *b,
                                               is_train=False), jax.random.PRNGKey(0))
    seeded = build_comp_model(cfg, device="cpu").module
    init_weights(seeded, torch.Generator().manual_seed(0))
    params = convert_state_dict({k: v.numpy() for k, v in seeded.state_dict().items()},
                                template, strict=True)[0]
    g_tx = jax_optim.build_optimizer(st["g_opt"], SCHEDULES[stage] or st["g_sched"], st["clip"])
    aux_tx = jax_optim.build_optimizer(st["aux_opt"], None, None)
    pol = JaxPolicy(**st["policy"])
    losses = {k: jax_build_loss(v) for k, v in st["losses"].items()}
    if stage != "1_3":
        step = make_rd_step(m, losses, g_tx, aux_tx, pol)
        start = _start(g_tx, aux_tx, params, 7)
    else:
        disc = DualBetaCondTamingNLayerDiscriminator(**DISC)
        bb = jnp.zeros((BATCH,))
        d_params = jax.jit(lambda r: disc.init(r, jnp.zeros((BATCH, 64, 64, 3)), bb, bb))(
            jax.random.PRNGKey(4))
        d_tx = jax_optim.build_optimizer(st["d_opt"], st["d_sched"], st["clip"])
        step = make_gan_step(m, disc, losses, g_tx, aux_tx, d_tx, pol)
        start = _start(g_tx, aux_tx, params, 7, d_tx, d_params)
    return _run(_recorded(step, m, pol, stage == "1_3"), start, batches,
                SNAPSHOTS if stage == "1_1" else (MOVED,))


def _child_run(stage: str) -> dict:
    """``_jax_run`` in a spawned process, with the tests' JAX settings."""
    import conftest  # noqa: F401
    return _jax_run(stage)


def _config(stage: str):
    return tiny_config(use_beta=stage != "1_1")


@pytest.fixture(scope="module")
def runs():
    """The three stages' JAX runs and their snapshots: stages 1_2 and 1_3 in
    two spawned processes while this one runs stage 1_1 (each run spends
    most of its time tracing its step, on one core)."""
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(2, mp_context=ctx) as pool:
        others = {k: pool.submit(_child_run, k) for k in ("1_2", "1_3")}
        held = {"1_1": _jax_run("1_1")}
        held.update({k: f.result() for k, f in others.items()})
    out = {}
    for k, h in held.items():
        st = _stage(k)
        out[k] = dict(cfg=_config(k), stage=st, held=h, sched=SCHEDULES[k] or st["g_sched"])
    return out


def _replay(monkeypatch, rec):
    """The port's step fed the JAX step's draws and betas."""
    noise = Noise(draws=[_port_layout(a) for a in rec["draws"]])
    monkeypatch.setattr(port_steps, "Noise", lambda generator: noise)
    betas = tuple(None if v is None else torch.from_numpy(np.asarray(v)) for v in rec["betas"])
    monkeypatch.setattr(port_steps.BetaPolicy, "sample", lambda self, *a, **k: betas)


def _flips(port, snap, gan):
    """How many of the estimator's tokens and of the straight-through
    roundings of y and z come out otherwise in the port's forward at the
    carried state, with the step's draws and betas, than in the JAX one."""
    rec = snap["rec"]
    betas = [torch.from_numpy(np.array(b)) for b in rec["betas"] if b is not None]
    with torch.no_grad():
        out = port(_nchw(snap["x"]), *betas, is_train=True, fix_entropy_models=gan,
                   noise=Noise(draws=[_port_layout(a) for a in rec["draws"]]))
    tokens = int((out["out_vq_logits"].argmax(1).numpy() != rec["tokens"]).sum())
    roundings = sum(int((np.abs(out["quantized_code"][k].numpy()
                                - _nchw(rec[k + "_hat"]).numpy()) > 0.5).sum())
                    for k in ("y", "z"))
    return tokens, roundings


def _port_step(run, snap, monkeypatch):
    """A fresh port model and optimizers carrying the snapshot's state, one
    step of the stage with its batch, draws and betas: the held ratios."""
    stage, before, after = run["stage"], snap["before"], snap["after"]
    gan = before.d_params is not None
    port = build_comp_model(run["cfg"], device="cpu").module
    load_reference_state_dict(port, export_state_dict(before.params))
    flips = _flips(port, snap, gan)
    g_opt, aux_opt = carried_optimizers(port, stage["g_opt"], run["sched"], stage["clip"],
                                        stage["aux_opt"], optax_adam_state(before.g_opt),
                                        optax_adam_state(before.aux_opt), gan)
    disc = d_opt = None
    if gan:
        disc = port_disc.DualBetaCondTamingNLayerDiscriminator(**DISC)
        load_reference_state_dict(disc, export_discriminator(before.d_params))
        d_opt = build_optimizer(dict(disc.named_parameters()), stage["d_opt"],
                                stage["d_sched"], stage["clip"])
        load_reference_optimizer_state(d_opt, *optax_adam_state(before.d_opt,
                                                                export_discriminator))
    sched = jax_optim.build_schedule(LR, run["sched"])
    lr_jax = float(sched(optax_adam_state(before.g_opt)[3]))
    lr_port = float(g_opt.lr())
    state = port_steps.TrainState(model=port, g_opt=g_opt, aux_opt=aux_opt, disc=disc,
                                  d_opt=d_opt, generator=torch.Generator().manual_seed(0))
    _replay(monkeypatch, snap["rec"])
    plosses = {k: build_loss(v) for k, v in stage["losses"].items()}
    policy = port_steps.BetaPolicy(**stage["policy"])
    if gan:
        terms = port_steps.gan_step(state, _nchw(snap["x"]), plosses, policy)
    else:
        terms = port_steps.rd_step(state, _nchw(snap["x"]), plosses, policy)
    monkeypatch.undo()
    clip = float(torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in g_opt.params if p.grad is not None])))
    model_sd = (export_state_dict(before.params), export_state_dict(after.params))
    opts = {"g": (g_opt, optax_adam_state(after.g_opt)) + model_sd}
    if not gan:
        opts["aux"] = (aux_opt, optax_adam_state(after.aux_opt)) + model_sd
    else:
        opts["d"] = (d_opt, optax_adam_state(after.d_opt, export_discriminator),
                     export_discriminator(before.d_params), export_discriminator(after.d_params))
    ratios = step_ratios(snap["terms"], {k: float(v) for k, v in terms.items()}, opts,
                         zero_by_construction(port), {"g": (lr_port, lr_jax)})
    return ratios, flips, clip


CASES = [("1_1", k) for k in SNAPSHOTS] + [("1_2", MOVED), ("1_3", MOVED)]


@pytest.mark.parametrize("stage,snapshot", CASES)
def test_one_step_from_the_reference_s_state(runs, stage, snapshot, monkeypatch):
    """The port's step from the JAX run's state after ``snapshot`` steps:
    its terms, updates, moments, quantiles, counts and rate against the
    JAX step's (every ratio of error to tolerance at most 1)."""
    run = runs[stage]
    snap = run["held"][snapshot]
    assert snap["terms"]["skipped"] == 0.0
    ratios, (tokens, ys), clip = _port_step(run, snap, monkeypatch)
    print(f"stage {stage} after {snapshot} steps: {tokens} token and {ys} rounding flips, "
          f"gradient norm {clip:.4g} (clip at {run['stage']['clip']}); "
          + ", ".join(f"{k} {r:.3g} ({n})" for k, (r, n) in sorted(ratios.items())))
    kinds = {"terms", "update", "mu", "nu", "counts", "lr"} | (
        set() if stage == "1_3" else {"quantiles"})
    assert set(ratios) == kinds
    bad = {k: v for k, v in ratios.items() if not v[0] <= 1.0}
    assert not bad, f"stage {stage} after {snapshot} steps: {bad}"


def test_the_run_moved_the_state(runs):
    """The snapshots are of a state that has moved: the warm-up's rate
    part way up and at its end, Adam's counts and second moments grown,
    the quantiles moved by the aux optimizer."""
    held = runs["1_1"]["held"]
    rates = [float(jax_optim.build_schedule(LR, WARMUP)(optax_adam_state(
        held[k]["before"].g_opt)[3])) for k in SNAPSHOTS]
    np.testing.assert_allclose(rates, [1e-4, 5.5e-4, 1e-3, 1e-3], rtol=1e-6)
    start = export_state_dict(held[0]["before"].params)
    last = export_state_dict(held[SNAPSHOTS[-1]]["before"].params)
    q = "entropy_model_z.quantiles"
    assert np.abs(last[q] - start[q]).max() > 1e-2
    _, nu, count, _ = optax_adam_state(held[SNAPSHOTS[-1]]["before"].g_opt)
    assert count == SNAPSHOTS[-1]
    assert max(float(np.max(v)) for v in nu.values()) > 1e-6


def test_optimizer_state_carries_bit_for_bit(runs):
    """A JAX Adam state after eight steps loads into the port's optimizers
    and comes back from their ``state_dict`` bit for bit, counts included;
    the moments of the weights a mask freezes are zeros in the JAX state
    and absent from the port's."""
    run = runs["1_1"]
    before = run["held"][8]["before"]
    port = build_comp_model(run["cfg"], device="cpu").module
    names = [n for n, _ in port.named_parameters()]
    for mask, key, cfg, sched in ((main_mask(names), "g_opt", run["stage"]["g_opt"], WARMUP),
                                  (aux_mask(names), "aux_opt", run["stage"]["aux_opt"], None)):
        opt = build_optimizer(masked_params(port, mask), cfg, sched)
        mu, nu, count, sched_count = optax_adam_state(getattr(before, key))
        load_reference_optimizer_state(opt, mu, nu, count, sched_count)
        got = opt.state_dict()
        assert (int(got["count"]), int(got["sched_count"])) == (count, sched_count) == (8, 8)
        for want, back in ((mu, got["mu"]), (nu, got["nu"])):
            assert set(back) == {n for n in names if mask[n]}
            for n, v in want.items():
                if n in back:
                    np.testing.assert_array_equal(back[n].numpy().reshape(v.shape), v,
                                                  err_msg=n)
                else:
                    assert not np.any(v), n


def test_optimizer_state_is_checked(runs):
    """The carry refuses a moment for a weight it trains that is missing,
    of another shape, or nonzero for a weight it does not train."""
    run = runs["1_1"]
    port = build_comp_model(run["cfg"], device="cpu").module
    names = [n for n, _ in port.named_parameters()]
    opt = build_optimizer(masked_params(port, aux_mask(names)), run["stage"]["aux_opt"])
    mu, nu, count, sched = optax_adam_state(run["held"][8]["before"].aux_opt)
    q = "entropy_model_z.quantiles"
    with pytest.raises(KeyError, match="missing"):
        load_reference_optimizer_state(opt, {k: v for k, v in mu.items() if k != q}, nu,
                                       count, sched)
    with pytest.raises(ValueError, match="shape"):
        load_reference_optimizer_state(opt, dict(mu, **{q: mu[q].ravel()}), nu, count, sched)
    frozen = next(n for n in names if n != q)
    with pytest.raises(ValueError, match="does not train"):
        load_reference_optimizer_state(opt, mu, dict(nu, **{frozen: np.ones_like(nu[frozen])}),
                                       count, sched)
