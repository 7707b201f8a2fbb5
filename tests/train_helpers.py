"""Shared pieces of the training parity tests (tests/test_torch_train_*.py,
tests/test_torch_fsdp.py) and of tests/soak_parity.py: weights carried
from the port into flax, layouts, the recorder of the JAX forward's noise
draws, optax's Adam state read out for the port, the one-step comparison
of a step taken from a carried state, the stage configs of the
data-parallel tests and the JAX data-parallel step they replay."""
import os
import sys
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from jax.sharding import NamedSharding, PartitionSpec

from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import convert_state_dict, export_state_dict
from dc_vic_tpu.parallel.mesh import data_parallel_step, fsdp_sharding_tree
from dc_vic_tpu.parallel.mesh import make_mesh as jax_mesh
from dc_vic_tpu.parallel.mesh import shard_batch as jax_shard
from dc_vic_tpu.train import optim as jax_optim
from dc_vic_tpu.train.losses import build_loss as jax_build_loss
from dc_vic_tpu.train.steps import BetaPolicy as JaxPolicy
from dc_vic_tpu.train.steps import TrainState as JaxState
from dc_vic_tpu.train.steps import make_rd_step
from dc_vic_tpu_torch.models import build_comp_model, init_weights
from dc_vic_tpu_torch.utils.config import load_config
from helpers import tiny_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP_WORLD = 2
DP_BATCH = 4                 # the global batch of the data-parallel tests: two images a rank
DP_G_OPT = {"type": "Adam", "lr": 1e-4}

TOL = dict(atol=1e-3, rtol=1e-3)     # the model tests' tolerance
GRAD_TOL = 1e-3                      # relative L2 per parameter tensor (+1e-7 absolute)
MOTION_TOL = 1e-3                    # relative L2 of an update or a moment (+1e-7 for updates)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _port_layout(a):
    """A JAX draw in the port's layout: NHWC maps to NCHW; the bottleneck's
    [C, 1, N] draw is the same in both."""
    a = np.array(a)
    return _nchw(a) if a.ndim == 4 else torch.from_numpy(a)


_TEMPLATES = {}


def _frozen(cfg):
    if isinstance(cfg, Mapping):
        return tuple(sorted((k, _frozen(v)) for k, v in cfg.items()))
    if isinstance(cfg, (list, tuple)):
        return tuple(_frozen(v) for v in cfg)
    return cfg


def flax_template(m, cfg):
    """The shapes of the flax parameters of ``m``, the JAX model built from
    ``cfg`` (``jax.eval_shape`` of its init: seconds of tracing), traced
    once per configuration in a process and shared by the port's test
    files."""
    key = _frozen(cfg)
    if key not in _TEMPLATES:
        x0, b = jnp.zeros((1, 64, 64, 3)), jnp.array([1.0])
        _TEMPLATES[key] = jax.eval_shape(
            lambda r: m.init({"params": r}, x0, b, b, is_train=False), jax.random.PRNGKey(0))
    return _TEMPLATES[key]


def jax_params(m, cfg):
    """Seeded port weights plus noise, carried into flax."""
    template = flax_template(m, cfg)
    seed = build_comp_model(cfg, device="cpu").module
    init_weights(seed, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    sd = {k: v.numpy() + rng.normal(0, 0.02, v.shape).astype(np.float32)
          for k, v in seed.state_dict().items()}
    return convert_state_dict(sd, template, strict=True)[0]


# the functions whose draws are the forward's noise (parameter initialisers,
# which flax traces lazily, draw too, and are left out)
_NOISE_SITES = {("codec/bottleneck.py", "__call__"), ("codec/gaussian.py", "__call__"),
                ("models/dc_vic.py", "decode_from_y_hat")}


def recording(monkeypatch, draws):
    """Wrap jax.random.uniform and jax.random.gumbel to append each noise
    draw of the forward."""
    for name in ("uniform", "gumbel"):
        orig = getattr(jax.random, name)

        def wrapped(*a, _orig=orig, **k):
            v = _orig(*a, **k)
            code = sys._getframe(1).f_code
            if any(code.co_filename.endswith(f) and code.co_name == fn
                   for f, fn in _NOISE_SITES):
                draws.append(v)
            return v
        monkeypatch.setattr(jax.random, name, wrapped)


def replaying(monkeypatch, source):
    """Wrap jax.random.uniform and jax.random.gumbel so that the forward's
    noise draws are instead ``source["draws"]``, in order (an iterator the
    caller sets, of arrays or tracers of the draws' shapes): a JAX forward
    fed a recorded step's noise."""
    for name in ("uniform", "gumbel"):
        orig = getattr(jax.random, name)

        def wrapped(*a, _orig=orig, **k):
            code = sys._getframe(1).f_code
            if any(code.co_filename.endswith(f) and code.co_name == fn
                   for f, fn in _NOISE_SITES):
                return next(source["draws"])
            return _orig(*a, **k)
        monkeypatch.setattr(jax.random, name, wrapped)


def zero_by_construction(module) -> set:
    """Names of the conv biases whose gradient is zero in exact arithmetic:
    the bias of a conv whose output goes straight into a GroupNorm of one
    channel per group (the tiny config's 8- and 16-channel blocks), which
    subtracts it again. Both packages give them rounding noise only."""
    from dc_vic_tpu_torch.nn.layers import FemasrResBlock, GNResBlock
    names = set()
    for prefix, m in module.named_modules():
        if isinstance(m, GNResBlock) and m.norm2.num_groups == m.norm2.weight.numel():
            names.add(f"{prefix}.conv1.bias")
        elif isinstance(m, FemasrResBlock):
            norm = m.conv[3].norm
            if norm.num_groups == norm.weight.numel():
                names.add(f"{prefix}.conv.2.bias")
    return names


def check_gradients(module, want, trained, zero=()):
    """Each trained parameter's .grad against ``want`` (numpy by name):
    relative L2 error within GRAD_TOL (+1e-7 absolute). A bias in ``zero``
    must instead be below GRAD_TOL times its conv weight's gradient in both
    packages (rounding noise). Untrained parameters have no gradient.
    Returns the number of tensors checked."""
    grads = dict(module.named_parameters())
    checked = 0
    for n, p in grads.items():
        if not trained.get(n, True):
            assert p.grad is None, n
            continue
        got = p.grad.numpy()
        w = np.asarray(want[n]).reshape(got.shape)
        if n in zero:
            scale = np.linalg.norm(grads[n[:-len("bias")] + "weight"].grad.numpy().ravel())
            assert max(np.linalg.norm(got), np.linalg.norm(w)) <= GRAD_TOL * scale, n
        else:
            err, ref = np.linalg.norm((got - w).ravel()), np.linalg.norm(w.ravel())
            assert err <= GRAD_TOL * ref + 1e-7, f"{n}: relative L2 error {err / ref:.3e}"
        checked += 1
    return checked


def stage_yaml(tmp, stage, load=None, **extra):
    """config/exp1_stage{stage}.yaml at the tiny widths on the synthetic
    images under ``tmp``, a global batch of DP_BATCH 64 x 64 crops."""
    tiny = tiny_config().to_plain()
    cfg = {
        "_base_": os.path.join(ROOT, "config", f"exp1_stage{stage}.yaml"),
        "subnet": dict(tiny["subnet"], _delete_=True),
        "exp": f"stage{stage}", "ckpt_root": os.path.join(tmp, "ckpt"), "seed": 0,
        "dataset": {"batch_size": DP_BATCH,
                    "train_dataset": {"root_dir": os.path.join(tmp, "data"),
                                      "subset_list": [0], "image_size": 64},
                    "eval_dataset": {"root_dir": os.path.join(tmp, "data", "kodak")}},
        "discriminator": {"ndf": 8, "n_layers": 2, "cond_ch": 4, "L": 4},
        "load_checkpoint": dict(load, _delete_=True) if load else None,
        **extra,
    }
    path = os.path.join(tmp, f"stage{stage}_{len(os.listdir(tmp))}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def jax_dp_step(case, fsdp_min_size=None, use_charm=True):
    """One JAX data-parallel stage 1_1 RD step on a mesh of DP_WORLD devices
    (the tiny stage 1_1 model, or its type without ChARM), the state
    replicated or, with ``fsdp_min_size``, sharded by
    ``fsdp_sharding_tree`` at that size; writes what a rank needs to replay
    it (weights, draws, batch, optimizers) to ``case`` and returns the JAX
    side's terms, weights before and after, Adam first moments, the names
    of the sharded weights, and the model and weights it ran (for further
    JAX calls on the same model)."""
    opt = load_config(os.path.join(ROOT, "config", "exp1_stage1_1.yaml"), is_train=True)
    losses_cfg = {k: dict(v) for k, v in dict(opt["loss"]).items()}
    clip, aux_cfg = opt["optim"]["clip_max_norm"], dict(opt["optim"]["aux_optimizer"])
    cfg = tiny_config(use_charm=use_charm, use_beta=False)
    m = jax_build(cfg).module
    params = jax_params(m, cfg)
    g_tx = jax_optim.build_optimizer(dict(DP_G_OPT), None, clip)
    aux_tx = jax_optim.build_optimizer(dict(aux_cfg), None, None)
    rd = make_rd_step(m, {k: jax_build_loss(v) for k, v in losses_cfg.items()}, g_tx, aux_tx,
                      JaxPolicy(use_beta=False))
    draws = []

    def step_and_draws(state, batch):
        del draws[:]
        new_state, terms = rd(state, batch)
        return new_state, (terms, list(draws))

    mesh = jax_mesh(DP_WORLD)
    batch = np.random.default_rng(11).uniform(-1, 1, (DP_BATCH, 64, 64, 3)).astype(np.float32)
    start = export_state_dict(params)

    def init(p):
        return JaxState(params=p, g_opt=g_tx.init(p), aux_opt=aux_tx.init(p),
                        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(7))
    # the state made and placed in one jit (the optimizers' eager init and
    # a placement apart take seconds more)
    shardings = None
    placed = NamedSharding(mesh, PartitionSpec())
    if fsdp_min_size is not None:
        shardings = placed = fsdp_sharding_tree(jax.eval_shape(init, params), mesh,
                                                min_size=fsdp_min_size)
    with jax.transfer_guard("allow"):
        state = jax.jit(init, out_shardings=placed)(params)
    step = data_parallel_step(step_and_draws, mesh, state_shardings=shardings)
    mp = pytest.MonkeyPatch()
    recording(mp, draws)
    try:
        state, (terms, got) = step(state, jax_shard(jnp.asarray(batch), mesh))
    finally:
        mp.undo()
    torch.save(dict(cfg=cfg.to_plain(), start=start, batch=batch, losses=losses_cfg,
                    clip=clip, aux_opt=aux_cfg, g_opt=dict(DP_G_OPT),
                    draws=[_port_layout(d) for d in got]), case + ".tmp")
    os.replace(case + ".tmp", case)

    def first_moments(opt_state):
        found = [s.mu for s in jax.tree.leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                 if hasattr(s, "mu")]
        assert len(found) == 1
        return export_state_dict(found[0])
    return dict(terms=jax.tree.map(float, terms), start=start,
                end=export_state_dict(state.params), n_draws=len(got),
                mu=dict(first_moments(state.g_opt), **{
                    k: v for k, v in first_moments(state.aux_opt).items()
                    if k.endswith("quantiles")}),
                sharded=None if shardings is None else sorted(
                    k for k, v in export_state_dict(jax.tree.map(
                        lambda x, s: np.full(x.shape, not s.is_fully_replicated), params,
                        shardings.params)).items() if np.all(v)),
                module=m, params=params)


def optax_adam_state(opt_state, export=export_state_dict):
    """The Adam state of an optax chain (``dc_vic_tpu/train/optim.py::
    build_optimizer``'s) in the arguments of the port's
    ``load_reference_optimizer_state``: the moments ``mu`` and ``nu`` by
    reference name (``export`` of the trees shaped like the weights),
    Adam's count and the schedule's (Adam's own where the rate is a
    constant and the chain keeps no schedule state)."""
    kinds = (optax.ScaleByAdamState, optax.ScaleByScheduleState)
    found = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: isinstance(s, kinds))
             if isinstance(s, kinds)]
    adam = [s for s in found if isinstance(s, optax.ScaleByAdamState)]
    sched = [s for s in found if isinstance(s, optax.ScaleByScheduleState)]
    assert len(adam) == 1 and len(sched) <= 1, (len(adam), len(sched))
    return (export(adam[0].mu), export(adam[0].nu), int(np.asarray(adam[0].count)),
            int(np.asarray((sched or adam)[0].count)))


def carried_optimizers(model, g_cfg, g_sched, clip, aux_cfg, g_state, aux_state,
                       gan=False):
    """Fresh port optimizers over ``model`` as the port's trainer builds
    them (``main_mask`` and ``aux_mask``; the quantiles train outside the
    GAN stages), carrying the reference's Adam states ``g_state`` and
    ``aux_state`` (``optax_adam_state``'s tuples)."""
    from dc_vic_tpu_torch.models.convert import load_reference_optimizer_state
    from dc_vic_tpu_torch.train.optim import aux_mask, build_optimizer, main_mask, masked_params
    names = [n for n, _ in model.named_parameters()]
    train, aux = main_mask(names, gan_stage=gan), aux_mask(names)
    for n, p in model.named_parameters():
        p.requires_grad_(train[n] or (aux[n] and not gan))
    g_opt = build_optimizer(masked_params(model, train), g_cfg, g_sched, clip)
    aux_opt = build_optimizer(masked_params(model, aux), aux_cfg)
    load_reference_optimizer_state(g_opt, *g_state)
    load_reference_optimizer_state(aux_opt, *aux_state)
    return g_opt, aux_opt


def export_discriminator(tree):
    """A flax discriminator tree (weights or Adam moments) by the port's
    names."""
    from dc_vic_tpu_torch.models.convert import discriminator_state_dict
    return discriminator_state_dict(jax.tree.map(np.asarray, tree))


def _ratio(err, ref, tol, floor=0.0):
    """``err`` over what the tolerance allows (``tol * ref + floor``): at
    most 1 holds; a zero allowance holds only a zero error."""
    allowed = tol * ref + floor
    return float(err / allowed) if allowed > 0 else (0.0 if err == 0 else float("inf"))


def step_ratios(jax_terms, port_terms, opts, zero=(), lrs=None):
    """One step taken from the same state in both packages, compared: for
    each quantity the worst ratio of its error to what the tolerance
    allows, and the tensor or term that gave it (``{kind: (ratio,
    name)}``; at most 1 holds).

    ``opts``: ``{label: (port optimizer after the step, the JAX Adam state
    after it (``optax_adam_state``), the JAX weights it trains before and
    after the step by reference name)}`` (the port's weights before are the
    same, carried); ``zero``: the biases whose gradient is zero by
    construction (``zero_by_construction``), whose update is held within
    the step's rate and whose moments within GRAD_TOL of their weight's, in
    both packages (rounding noise); ``lrs``: ``{label: (port rate, JAX
    rate)}`` of the step.

    Kinds: ``terms`` (atol = rtol = 1e-3), ``update`` (relative L2
    MOTION_TOL + 1e-7), ``mu`` and ``nu`` (relative L2 MOTION_TOL),
    ``quantiles`` (their values after the step, TOL), ``counts`` (0 or
    inf) and ``lr`` (relative 1e-6)."""
    worst = {}

    def note(kind, ratio, name):
        if kind not in worst or ratio > worst[kind][0]:
            worst[kind] = (ratio, name)
    for k, w in jax_terms.items():
        g = port_terms[k]
        note("terms", _ratio(abs(g - w), abs(w), TOL["rtol"], TOL["atol"]), k)
    for label, (opt, (mu, nu, count, sched), before, after) in opts.items():
        got = opt.state_dict()
        note("counts", 0.0 if (int(got["count"]), int(got["sched_count"])) == (count, sched)
             else float("inf"), f"{label}: {int(got['count'])}/{int(got['sched_count'])} "
             f"against {count}/{sched}")
        for n, p in zip(opt.names, opt.params):
            new = p.detach().cpu().numpy()
            step = new - np.asarray(before[n]).reshape(new.shape)
            ref = np.asarray(after[n]).reshape(new.shape) - np.asarray(before[n]).reshape(new.shape)
            if n in zero:
                weight = n[:-len("bias")] + "weight"
                lr = max(lrs[label]) if lrs else 1.0
                note("update", max(np.abs(step).max(), np.abs(ref).max()) / lr, n)
                for key, want, power in (("mu", mu, 1), ("nu", nu, 2)):
                    scale = np.linalg.norm(np.asarray(want[weight]).ravel())
                    small = max(np.linalg.norm(got[key][n].cpu().numpy().ravel()),
                                np.linalg.norm(np.asarray(want[n]).ravel()))
                    note(key, _ratio(small, scale, GRAD_TOL ** power), n)
                continue
            note("update", _ratio(np.linalg.norm((step - ref).ravel()),
                                  np.linalg.norm(ref.ravel()), MOTION_TOL, 1e-7), n)
            for key, want in (("mu", mu), ("nu", nu)):
                g = got[key][n].cpu().numpy()
                w = np.asarray(want[n]).reshape(g.shape)
                note(key, _ratio(np.linalg.norm((g - w).ravel()), np.linalg.norm(w.ravel()),
                                 MOTION_TOL), n)
            if n.endswith("quantiles"):
                w = np.asarray(after[n]).reshape(new.shape)
                note("quantiles", float(np.max(np.abs(new - w) / (TOL["atol"]
                                                                  + TOL["rtol"] * np.abs(w)))), n)
    for label, (got, want) in (lrs or {}).items():
        note("lr", _ratio(abs(got - want), abs(want), 1e-6), label)
    return worst


# the straight-through roundings and the estimator's argmax of the training
# forward: the decisions at which a near-tie can come out differently in the
# two packages
TAP_SITES = {"round": ("codec/ops.py", "ste_round"),
             "argmax": ("models/dc_vic.py", "decode_from_y_hat")}


def tap_jax(mp, taps):
    """Wrap jnp.round and jnp.argmax so that, at the ``TAP_SITES``, their
    results reach ``taps`` (a dict, by their order in the forward) as
    ``(kind, value)``: through a host callback, so that a jitted step hands
    them over each time it runs."""
    for kind, (path, fn) in TAP_SITES.items():
        orig = getattr(jnp, kind)

        def wrapped(*a, _orig=orig, _kind=kind, _path=path, _fn=fn, **k):
            v = _orig(*a, **k)
            code = sys._getframe(1).f_code
            if code.co_filename.endswith(_path) and code.co_name == _fn:
                i = len(taps)
                taps[i] = None
                jax.debug.callback(
                    lambda a, i=i, n=_kind: taps.__setitem__(i, (n, np.asarray(a))), v)
            return v
        mp.setattr(jnp, kind, wrapped)


def tap_port(monkeypatch, taps, force=None):
    """The same decisions in the port's forward (its straight-through
    roundings and the estimator's argmax), appended to ``taps`` in order.
    With ``force`` (the JAX forward's taps, in order), each decision is
    then taken as the JAX forward took it: the port's step with the
    reference's tokens and roundings."""
    from dc_vic_tpu_torch.codec import bottleneck, gaussian
    from dc_vic_tpu_torch.codec.ops import ste_round

    def decided(i, own):
        want = np.asarray(force[i][1])
        return torch.from_numpy(_port_layout(want).numpy() if want.ndim == 4 else want).to(
            own.dtype)

    def rounding(x):
        taps.append(("round", torch.round(x.detach()).numpy()))
        if force is None:
            return ste_round(x)
        return x + (decided(len(taps) - 1, x) - x).detach()
    for mod in (bottleneck, gaussian):
        monkeypatch.setattr(mod, "ste_round", rounding)
    orig = torch.argmax

    def argmax(*a, **k):
        v = orig(*a, **k)
        code = sys._getframe(1).f_code
        path, fn = TAP_SITES["argmax"]
        if code.co_filename.endswith(path) and code.co_name == fn:
            taps.append(("argmax", v.numpy()))
            if force is not None:
                v = decided(len(taps) - 1, v)
        return v
    monkeypatch.setattr(torch, "argmax", argmax)


def count_flips(jax_taps, port_taps):
    """How many of the estimator's tokens and of the straight-through
    roundings (z, then y's slices) came out differently in the two
    packages' forwards of the same step."""
    assert [k for k, _ in port_taps] == [k for k, _ in jax_taps]
    counts = {"argmax": 0, "round": 0}
    for (kind, want), (_, got) in zip(jax_taps, port_taps):
        want = np.asarray(want)
        counts[kind] += int((got != (_port_layout(want).numpy() if want.ndim == 4
                                     else want)).sum())
    return counts["argmax"], counts["round"]
