"""The soak's RD stage through the JAX trainer and the port's, on the CPU,
from one seed: does the port train like the reference, and what do the
training images' JPEG files change?

    JAX_PLATFORMS=cpu python tests/soak_parity.py --iters 600 --eval_step 100 --out DIR

Runs of the small RD configuration of ``tests/test_torch_soak.py``
(``docs/artifacts/soak_stage1_1_config.yaml`` with the VQGAN, hyperprior,
context model and estimator narrowed; 64x64 images at batch 2), each
trainer built from the same options and seed (``--seed``: the weights'
initial draws, the batches and the noise; the images are always seed 0's):

* ``{jax,port}_jpeg``: the training images ``scripts/soak.py`` writes, JPEG
  at quality 92 (the TPU soak's data);
* ``{jax,port}_lossless``: the same pixels before JPEG, the port soak's
  ``.npy`` arrays written as PNG so that both trainers read the same files;
* ``portjaxinit_{jpeg,lossless}``: the port's trainer started from the JAX
  trainer's initial weights (``export_state_dict`` of its seeded init),
  which separates the two packages' initial draws from their training;
* ``portreplay_{jpeg,lossless}``: the JAX trainer's run with every step's
  noise draws recorded (its ``step_fn`` wrapped: a jitted forward on the
  step's model key under ``train_helpers.recording``), then the port's
  trainer from the JAX init fed those draws (``train/steps.py::_noise``
  patched to replay them): the two trainers differ in nothing but their
  arithmetic. The entry adds the JAX run's J (``jax_J``) and the port's
  evaluation of the JAX run's final weights (``J_port_eval_of_jax``);
* ``jaxulp{1,2,3}_jpeg``: the JAX trainer with every value of one weight
  of its init moved up by one ULP (``np.nextafter``; the first kernel of
  the encoder, the context model and the decoder, named in the entry's
  ``nudged``): the spread of J that rounding alone makes.

``--snapshots SNAPDIR`` saves, in the ``portreplay`` runs, every
``SNAP_EVERY``-th step of the JAX run whole (weights, both Adam states and
counts before and after it, its batch, draws and terms) as
``SNAPDIR/<run>_s<seed>/stepNNNNN.npz``; ``--check_along SNAPDIR`` then
takes each saved step again in the port from the saved state and holds it
as ``tests/test_torch_train_along_reference.py`` does
(``train_helpers.step_ratios``), writing the worst ratio of error to
tolerance of each kind, and each step's near-tie flips, to ``summary.json``
(``check_along_<run>_s<seed>``); ``--bisect SNAPDIR/<run>_s<seed>/stepNNNNN.npz``
takes one saved step apart (``bisect_<run>_s<seed>_stepNNNNN``).

Every run evaluates on the script's PNGs (the port soak's eval arrays are
the same pixels). ``DIR`` receives each run's eval and loss CSVs (``<run>_s<seed>_*.csv``) and
``summary.json`` (runs of other invocations into the same ``DIR`` are
kept): J = W_RATE * bpp + W_DIST * mse_01 at every eval point,
PSNR and bpp, the last logged losses and the seconds of each run; with
``--init_stats`` (``--runs ''`` for that alone) the spread of the port's
initial weights against the JAX trainer's (``init_spread``).
"""
from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT, HERE]
SIZE = 64      # the images' side: the small config's VQGAN resolution
THREADS = 4    # PyTorch's CPU threads a run, so that runs can share the CPU
SNAP_EVERY = 50                                  # the steps --snapshots saves
ULP_ROOTS = ("encoder", "context_model", "decoder")   # jaxulp{1,2,3}'s weights


def _script():
    spec = importlib.util.spec_from_file_location("tpu_soak_script",
                                                  os.path.join(ROOT, "scripts", "soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lossless(npy_root: str, out: str) -> str:
    """The port soak's training arrays as PNG files, same names."""
    from PIL import Image
    src = os.path.join(npy_root, "train_0")
    dst = os.path.join(out, "train_0")
    os.makedirs(dst, exist_ok=True)
    for name in sorted(os.listdir(src)):
        Image.fromarray(np.load(os.path.join(src, name))).save(
            os.path.join(dst, name[:-4] + ".png"))
    return out


def _opt(load_config, cfg: str, exp: str, work: str, train_root: str, eval_root: str,
         iters: int, eval_step: int, seed: int):
    opt = load_config(cfg, is_train=True)
    opt.update(exp=exp, ckpt_root=os.path.join(work, "checkpoint"), total_iter=iters,
               eval_step=eval_step, save_step=iters, keep_step=[iters],
               log_step=min(25, max(1, iters // 4)), seed=seed)
    opt["dataset"]["train_dataset"]["root_dir"] = train_root
    opt["dataset"]["eval_dataset"]["root_dir"] = eval_root
    return opt


def _jax_init(opt) -> dict:
    """The JAX trainer's initial weights for ``opt`` (its seed) as numpy
    arrays under the port's names."""
    import jax
    from dc_vic_tpu.models.convert import export_state_dict
    from dc_vic_tpu.train.trainer import build_trainer
    opt = copy.deepcopy(opt)
    opt["exp"] += "_jax_init"
    return export_state_dict(jax.device_get(build_trainer(opt).state.params))


def _adam(prefix: str, opt_state) -> dict:
    """An optax Adam state as flat arrays under ``prefix``."""
    from train_helpers import optax_adam_state
    mu, nu, count, sched = optax_adam_state(opt_state)
    out = {f"{prefix}/mu/{k}": v for k, v in mu.items()}
    out.update({f"{prefix}/nu/{k}": v for k, v in nu.items()})
    out.update({f"{prefix}/count": np.int32(count), f"{prefix}/sched_count": np.int32(sched)})
    return out


def _save_snapshot(path: str, before, after, x, draws, terms) -> None:
    """One JAX step whole: the weights and both Adam states before and
    after it (reference names), its batch, noise draws and terms."""
    import jax
    from dc_vic_tpu.models.convert import export_state_dict
    arrays = {"x": np.asarray(x)}
    arrays.update({f"draw/{i}": d for i, d in enumerate(draws)})
    arrays.update({f"terms/{k}": np.float64(v) for k, v in terms.items()})
    for tag, state in (("before", before), ("after", after)):
        host = jax.device_get(state)
        arrays.update({f"{tag}/params/{k}": v for k, v in export_state_dict(host.params).items()})
        for opt in ("g_opt", "aux_opt"):
            arrays.update(_adam(f"{tag}/{opt}", getattr(host, opt)))
    np.savez_compressed(path + ".tmp.npz", **arrays)
    os.replace(path + ".tmp.npz", path)


def _load_snapshot(path: str) -> dict:
    """A saved step as ``{"x", "draws", "terms", "before"/"after": {"params",
    "g_opt"/"aux_opt": (mu, nu, count, sched_count)}}``."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    snap = {"x": flat["x"], "terms": {}, "draws": [None] * sum(k.startswith("draw/")
                                                               for k in flat)}
    for tag in ("before", "after"):
        snap[tag] = {"params": {}}
        for opt in ("g_opt", "aux_opt"):
            snap[tag][opt] = ({}, {}, int(flat[f"{tag}/{opt}/count"]),
                              int(flat[f"{tag}/{opt}/sched_count"]))
    for k, v in flat.items():
        head, _, rest = k.partition("/")
        if head == "draw":
            snap["draws"][int(rest)] = v
        elif head == "terms":
            snap["terms"][rest] = float(v)
        elif head in ("before", "after"):
            kind, _, name = rest.partition("/")
            if kind == "params":
                snap[head]["params"][name] = v
            elif name.startswith(("mu/", "nu/")):
                snap[head][kind][name[:2] == "nu"][name[3:]] = v
    return snap


def _recording_step(tr, snap_dir=None) -> list:
    """Wrap the JAX trainer ``tr``'s step: each step's noise draws are
    appended to the returned list (a jitted forward on the step's model
    key under ``train_helpers.recording``: the draws depend on the key
    alone), and with ``snap_dir`` every SNAP_EVERY-th step is saved whole."""
    import jax
    import pytest
    from train_helpers import recording
    m, step_fn, recorded, draws = tr.module, tr.step_fn, [], []
    mp = pytest.MonkeyPatch()

    @jax.jit
    def forward_draws(p, x, rng):
        del draws[:]
        m.apply(p, x, is_train=True, rng=jax.random.split(rng, 3)[2])
        return list(draws)

    def step(state, x):
        if not recorded:
            recording(mp, draws)
        try:
            got = [np.asarray(d) for d in forward_draws(state.params, x, state.rng)]
        finally:
            mp.undo()
        recorded.append(got)
        i = len(recorded) - 1
        # the step donates its state: the one to save is copied out first
        before = jax.device_get(state) if snap_dir is not None and i % SNAP_EVERY == 0 else None
        new, metrics = step_fn(state, x)
        if before is not None:
            _save_snapshot(os.path.join(snap_dir, f"step{i:05d}.npz"), before, new, x, got,
                           {k: float(v) for k, v in metrics.items()})
        return new, metrics
    tr.step_fn = step
    return recorded


def _nudge(tr, root: str) -> str:
    """Move every value of the first kernel under ``root`` in the JAX
    trainer ``tr``'s weights up by one ULP; its reference name."""
    import jax
    from flax import traverse_util
    from dc_vic_tpu.models.convert import PathMapper
    flat = traverse_util.flatten_dict(tr.state.params)
    path = next(p for p in flat if p[1] == root and p[-1] == "kernel")
    leaf = flat[path]
    flat[path] = jax.device_put(np.nextafter(np.asarray(leaf), np.float32(np.inf)),
                                leaf.sharding)
    tr.state = tr.state.replace(params=traverse_util.unflatten_dict(flat))
    return PathMapper().map_path(path)[0]


def _replaying(recorded):
    """The port's ``train/steps.py::_noise`` patched to hand out the
    recorded draws, one step's at a time (a MonkeyPatch to undo)."""
    import pytest
    from dc_vic_tpu_torch.codec.ops import Noise
    from dc_vic_tpu_torch.train import steps as port_steps
    from train_helpers import _port_layout
    it = iter(recorded)
    mp = pytest.MonkeyPatch()
    mp.setattr(port_steps, "_noise", lambda generator, dp: Noise(
        draws=[_port_layout(d) for d in next(it)]))
    return mp


def _summary(paths, secs: float) -> dict:
    from dc_vic_tpu_torch.tools import soak
    ev, loss = soak.read_csv(paths.eval_csv_path), soak.read_csv(paths.loss_csv_path)
    return {"iters": [int(r["iter"]) for r in ev],
            "J": [soak.rd_objective(float(r["bpp"]), float(r["psnr"])) for r in ev],
            "psnr": [float(r["psnr"]) for r in ev], "bpp": [float(r["bpp"]) for r in ev],
            "last_loss": {k: float(v) for k, v in loss[-1].items() if v not in ("", None)},
            "seconds": secs}


def run(side: str, data: str, cfg: str, work: str, roots, eval_root: str, iters: int,
        eval_step: int, seed: int, out: str, snapshots=None):
    """One run; its CSVs copied to ``out``; its summary."""
    from dc_vic_tpu.train.trainer import build_trainer as jax_trainer
    from dc_vic_tpu.utils.config import load_config as jax_config
    from dc_vic_tpu.utils.paths import PathHandler as JaxPaths
    from dc_vic_tpu_torch.models.convert import load_reference_state_dict
    from dc_vic_tpu_torch.tools import soak
    from dc_vic_tpu_torch.train.trainer import build_trainer
    from dc_vic_tpu_torch.utils.config import load_config
    from dc_vic_tpu_torch.utils.paths import PathHandler
    exp = f"{side}_{data}_s{seed}"
    extra, t = {}, time.perf_counter()
    if side == "jax" or side.startswith("jaxulp"):
        opt = _opt(jax_config, cfg, exp, work, roots[data], eval_root, iters, eval_step, seed)
        paths = JaxPaths(opt["ckpt_root"], exp)
        paths.make_job_dir()
        tr = jax_trainer(opt)
        if side != "jax":
            extra["nudged"] = _nudge(tr, ULP_ROOTS[int(side[len("jaxulp"):]) - 1])
        tr.train_loop()
    else:
        opt = _opt(load_config, cfg, exp, work, roots[data], eval_root, iters, eval_step, seed)
        paths = PathHandler(opt["ckpt_root"], exp)
        paths.make_job_dir()
        init, mp = None, None
        if side in ("portjaxinit", "portreplay"):
            import jax
            from dc_vic_tpu.models.convert import export_state_dict
            jopt = _opt(jax_config, cfg, exp + "_jax", work, roots[data], eval_root, iters,
                        eval_step, seed)
            JaxPaths(jopt["ckpt_root"], jopt["exp"]).make_job_dir()
            jtr = jax_trainer(jopt)
            init = export_state_dict(jax.device_get(jtr.state.params))
        if side == "portreplay":
            snap_dir = None
            if snapshots:
                snap_dir = os.path.join(snapshots, exp)
                os.makedirs(snap_dir, exist_ok=True)
            recorded = _recording_step(jtr, snap_dir)
            jtr.train_loop()
            jpaths = JaxPaths(jopt["ckpt_root"], jopt["exp"])
            extra["jax_J"] = _summary(jpaths, 0.0)["J"]
            final = export_state_dict(jax.device_get(jtr.state.params))
            mp = _replaying(recorded)
        tr = build_trainer(opt, device="cpu")
        if init is not None:
            load_reference_state_dict(tr.model, init)
        try:
            tr.train_loop()
        finally:
            if mp is not None:
                mp.undo()
    secs = time.perf_counter() - t
    for kind, path in (("eval", paths.eval_csv_path), ("loss", paths.loss_csv_path)):
        shutil.copy(path, os.path.join(out, f"{exp}_{kind}.csv"))
    summary = dict(_summary(paths, secs), **extra)
    if side == "portreplay":
        # the port's evaluation of the JAX run's last weights: J apart from
        # training
        load_reference_state_dict(tr.model, final)
        ev = tr._validate(iters, 24)
        summary["J_port_eval_of_jax"] = soak.rd_objective(ev["bpp"], ev["psnr"])
    return summary


def _force_vq_targets(mp, model, indices) -> None:
    """Patch ``model.vq_encode`` to quantize to the token map ``indices``
    (the JAX forward's) instead of its own nearest codewords."""
    import torch

    def vq_encode(x):
        h = model.vq_model.encode(x).float()
        idx = torch.from_numpy(np.array(indices))
        return h + (model.vq_model.quantize.lookup(idx).to(h.dtype) - h), idx
    mp.setattr(model, "vq_encode", vq_encode)


class _PortStep:
    """The port's side of a saved step of the small RD config: a fresh
    model and fresh optimizers carrying the step's state, then one
    ``rd_step`` on its batch and draws (with ``force``, the JAX forward's
    decisions), or, with ``grads`` (by reference name), the optimizers'
    step on those gradients alone."""

    def __init__(self, cfg: str):
        from dc_vic_tpu_torch.train.losses import build_loss
        from dc_vic_tpu_torch.utils.config import load_config
        self.opt = load_config(cfg, is_train=True)
        optim = dict(self.opt["optim"])
        self.clip = optim.get("clip_max_norm")
        self.g_cfg = dict(optim["g_optimizer"])
        self.sched_cfg = dict(optim["g_scheduler"]) if optim.get("g_scheduler") else None
        self.aux_cfg = dict(optim.get("aux_optimizer") or {"lr": 1e-3})
        self.losses = {k: build_loss(dict(v)) for k, v in dict(self.opt["loss"]).items()
                       if isinstance(v, dict) and v.get("type")}

    def __call__(self, snap, force=None, grads=None, force_gt=None) -> dict:
        import pytest
        import torch
        from dc_vic_tpu.train.optim import build_schedule as jax_schedule
        from dc_vic_tpu_torch.codec.ops import Noise
        from dc_vic_tpu_torch.models import build_comp_model
        from dc_vic_tpu_torch.models.convert import load_reference_state_dict
        from dc_vic_tpu_torch.train import steps as port_steps
        from train_helpers import (_nchw, _port_layout, carried_optimizers, step_ratios,
                                   tap_port, zero_by_construction)
        model = build_comp_model(self.opt, device="cpu").module.train()
        load_reference_state_dict(model, snap["before"]["params"])
        g_opt, aux_opt = carried_optimizers(model, self.g_cfg, self.sched_cfg, self.clip,
                                            self.aux_cfg, snap["before"]["g_opt"],
                                            snap["before"]["aux_opt"])
        count = snap["before"]["g_opt"][3]
        lrs = {"g": (float(g_opt.lr()), float(jax_schedule(self.g_cfg["lr"], self.sched_cfg)(
            count) if self.sched_cfg else self.g_cfg["lr"]))}
        taps, terms = [], {}
        with torch.no_grad():
            gt = model.vq_encode(_nchw(snap["x"]))[1].numpy()
        if grads is not None:
            for opt in (g_opt, aux_opt):
                opt.step([torch.from_numpy(np.array(grads[n])).reshape(p.shape)
                          for n, p in zip(opt.names, opt.params)])
        else:
            state = port_steps.TrainState(model=model, g_opt=g_opt, aux_opt=aux_opt,
                                          generator=torch.Generator().manual_seed(0))
            noise = Noise(draws=[_port_layout(d) for d in snap["draws"]])
            mp = pytest.MonkeyPatch()
            mp.setattr(port_steps, "Noise", lambda generator: noise)
            tap_port(mp, taps, force)
            if force_gt is not None:
                _force_vq_targets(mp, model, force_gt)
            try:
                terms = port_steps.rd_step(state, _nchw(snap["x"]), self.losses,
                                           port_steps.BetaPolicy(use_beta=False))
            finally:
                mp.undo()
        sd = (snap["before"]["params"], snap["after"]["params"])
        ratios = step_ratios({k: v for k, v in snap["terms"].items() if k in terms},
                             {k: float(v) for k, v in terms.items()},
                             {"g": (g_opt, snap["after"]["g_opt"]) + sd,
                              "aux": (aux_opt, snap["after"]["aux_opt"]) + sd},
                             zero_by_construction(model), lrs)
        return dict(ratios=ratios, taps=taps, gt=gt, model=model, g_opt=g_opt)


def _jax_side(cfg: str):
    """The JAX model of the small RD config, its flax template, and a
    function of a saved step and a traced body that runs the body on the
    step's weights, batch and draws (replayed by
    ``train_helpers.replaying``)."""
    import jax
    import jax.numpy as jnp
    import pytest
    from dc_vic_tpu.models import build_comp_model as jax_build
    from dc_vic_tpu.models.convert import convert_state_dict
    from dc_vic_tpu.utils.config import load_config as jax_config
    from train_helpers import replaying
    opt = jax_config(cfg, is_train=True)
    m = jax_build(opt).module
    template = jax.eval_shape(lambda r: m.init({"params": r}, jnp.zeros((1, SIZE, SIZE, 3)),
                                               is_train=False), jax.random.PRNGKey(0))
    source, mp = {}, pytest.MonkeyPatch()

    def bind(body, before=None):
        @jax.jit
        def fn(params, x, draws):
            source["draws"] = iter(draws)
            return body(params, x)

        def of(snap):
            params = convert_state_dict(snap["before"]["params"], template, strict=True)[0]
            replaying(mp, source)
            if before is not None:
                before(mp)
            try:
                return fn(params, snap["x"], list(snap["draws"]))
            finally:
                mp.undo()
        return of
    return opt, m, bind


def _jax_taps(cfg: str):
    """A function of a saved step: the decisions (``train_helpers.tap_jax``)
    of the JAX forward at its state, on its batch and draws, and the frozen
    VQGAN's token map of the batch (the code losses' targets)."""
    import jax
    from train_helpers import tap_jax
    _, m, bind = _jax_side(cfg)
    taps = {}

    def body(params, x):
        return m.apply(params, x, is_train=True, rng=jax.random.PRNGKey(0))["gt_vq_indices"]
    run = bind(body, lambda mp: tap_jax(mp, taps))

    def of(snap):
        gt = np.asarray(run(snap))
        jax.effects_barrier()
        return [taps[i] for i in range(len(taps))], gt
    return of


def _jax_grads(cfg: str):
    """A function of a saved step: the JAX step's gradients at its state
    (``make_rd_step``'s ``loss_fn`` and ``aux_fn`` under
    ``jax.value_and_grad``, frozen leaves zeroed by the masks), by
    reference name, main and aux summed (they touch disjoint weights)."""
    import jax
    from dc_vic_tpu.models.convert import export_state_dict
    from dc_vic_tpu.train.losses import build_loss
    from dc_vic_tpu.train.optim import aux_mask, main_mask, zero_frozen_grads
    from dc_vic_tpu.train.steps import BetaPolicy, _g_losses
    opt, m, bind = _jax_side(cfg)
    losses = {k: build_loss(dict(v)) for k, v in dict(opt["loss"]).items()
              if isinstance(v, dict) and v.get("type")}
    policy = BetaPolicy(use_beta=False)

    def body(params, x):
        def loss_fn(p):
            out = m.apply(p, x, is_train=True, rng=jax.random.PRNGKey(0))
            return _g_losses(m, losses, out, x, None, None, policy, include_rate=True)
        _, g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        ga = jax.grad(lambda p: m.apply(p, method=m.aux_loss))(params)
        g = zero_frozen_grads(g["params"], main_mask(params["params"]))
        ga = zero_frozen_grads(ga["params"], aux_mask(params["params"]))
        return jax.tree.map(lambda a, b: a + b, g, ga)
    run = bind(body)
    return lambda snap: export_state_dict({"params": jax.device_get(run(snap))})


def _port_grads(port_step: "_PortStep", snap, dtype, force, force_gt):
    """The port's gradients of a saved step's losses (no optimizer) in
    ``dtype`` with the JAX forward's decisions forced, and the sign of every
    ReLU output in call order. In float64 every tensor is held in float64
    (``Tensor.float`` is patched to keep a floating tensor's dtype)."""
    import pytest
    import torch
    import torch.nn.functional as F
    from dc_vic_tpu_torch.codec.ops import Noise
    from dc_vic_tpu_torch.models import build_comp_model
    from dc_vic_tpu_torch.models.convert import load_reference_state_dict
    from dc_vic_tpu_torch.train import steps as port_steps
    from train_helpers import _nchw, _port_layout, carried_optimizers, tap_port
    model = build_comp_model(port_step.opt, device="cpu").module.train()
    load_reference_state_dict(model, snap["before"]["params"])
    carried_optimizers(model, port_step.g_cfg, port_step.sched_cfg, port_step.clip,
                       port_step.aux_cfg, snap["before"]["g_opt"], snap["before"]["aux_opt"])
    mp, signs = pytest.MonkeyPatch(), []
    if dtype == torch.float64:
        model.double()
        to_f32 = torch.Tensor.float
        mp.setattr(torch.Tensor, "float",
                   lambda t, *a, **k: t if t.is_floating_point() else to_f32(t, *a, **k))
    relu = F.relu

    def signed(x, *a, **k):
        y = relu(x, *a, **k)
        signs.append((y > 0).numpy().copy())
        return y
    mp.setattr(F, "relu", signed)
    tap_port(mp, [], force)
    _force_vq_targets(mp, model, force_gt)
    noise = Noise(draws=[_port_layout(d).to(dtype) for d in snap["draws"]])
    try:
        total, _, _ = port_steps.rd_losses(model, port_step.losses, _nchw(snap["x"]).to(dtype),
                                           None, None, port_steps.BetaPolicy(use_beta=False),
                                           noise)
        (total + model.aux_loss()).backward()
    finally:
        mp.undo()
    return ({n: p.grad.detach().double().numpy() for n, p in model.named_parameters()
             if p.grad is not None}, signs)


def check_along(cfg: str, snap_dir: str) -> dict:
    """Each step saved in ``snap_dir`` taken again by the port from the
    saved state, with its batch and draws, and held against the JAX step:
    for each kind the worst ratio of error to tolerance (at most 1 holds),
    the tensor or term and the step that gave it, and each step's ratios
    and near-tie flips (``train_helpers.count_flips``; and of the frozen
    VQGAN's token map, the code losses' targets). A step that does not
    hold is taken once more with the JAX forward's tokens, roundings and
    targets (``train_helpers.tap_port(force=...)``): ``forced`` holds its
    ratios, which say whether the flips account for the miss."""
    from train_helpers import count_flips
    port_step, jax_taps = _PortStep(cfg), _jax_taps(cfg)
    worst, steps = {}, {}
    for name in sorted(os.listdir(snap_dir)):
        snap = _load_snapshot(os.path.join(snap_dir, name))
        want, gt = jax_taps(snap)
        got = port_step(snap)
        ratios = got["ratios"]
        tokens, roundings = count_flips(want, got["taps"])
        step = int(name[len("step"):-len(".npz")])
        steps[step] = {"ratios": {k: r for k, (r, _) in ratios.items()},
                       "worst": {k: n for k, (r, n) in ratios.items() if r > 1.0},
                       "token_flips": tokens, "rounding_flips": roundings,
                       "vq_target_flips": int((got["gt"] != gt).sum())}
        if any(r > 1.0 for r, _ in ratios.values()):
            forced = port_step(snap, force=want, force_gt=gt)["ratios"]
            steps[step]["forced"] = {k: r for k, (r, _) in forced.items()}
        for k, (r, n) in ratios.items():
            if k not in worst or r > worst[k][0]:
                worst[k] = [r, n, step]
        print(name, json.dumps(steps[step]), flush=True)
    return {"steps": len(steps), "held": all(r <= 1.0 for r, _, _ in worst.values()),
            "held_with_the_reference_s_decisions": all(
                max(s.get("forced", s["ratios"]).values()) <= 1.0 for s in steps.values()),
            "worst": worst, "per_step": steps}


def bisect(cfg: str, path: str) -> dict:
    """One saved step taken apart: the port's gradients against the JAX
    step's per trained tensor (relative L2, GRAD_TOL), the clip's global
    norms, the port's optimizers stepped on the JAX gradients (the update
    and moments then depend on the optimizers alone), and for the tensor
    whose update misses most, the share of its update error on elements
    whose gradient has another sign in the two packages. Then the port's
    gradients again in float32 and in float64, with the JAX forward's
    tokens, roundings and targets forced: each package's float32 gradients
    against the float64 ones (relative L2 per tensor: median and largest),
    and the ReLU outputs whose sign differs between the port's float32 and
    float64 forwards (a kink rounded to its other side)."""
    import torch
    from train_helpers import GRAD_TOL, _ratio
    snap = _load_snapshot(path)
    port_step = _PortStep(cfg)
    got = port_step(snap)
    want = _jax_grads(cfg)(snap)
    jtaps, jgt = _jax_taps(cfg)(snap)
    g32, s32 = _port_grads(port_step, snap, torch.float32, jtaps, jgt)
    g64, s64 = _port_grads(port_step, snap, torch.float64, jtaps, jgt)

    def against_f64(grads):
        errs = {n: float(np.linalg.norm((np.asarray(grads[n], np.float64).reshape(r.shape)
                                          - r).ravel()) / np.linalg.norm(r.ravel()))
                for n, r in g64.items() if np.linalg.norm(r.ravel()) > 0}
        worst = max(errs, key=errs.get)
        return {"median": float(np.median(list(errs.values()))), "max": [worst, errs[worst]],
                "over_GRAD_TOL": sum(e > GRAD_TOL for e in errs.values()), "tensors": len(errs)}
    model, g_opt = got["model"], got["g_opt"]
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    ratios = {n: _ratio(np.linalg.norm((g - np.asarray(want[n]).reshape(g.shape)).ravel()),
                        np.linalg.norm(np.asarray(want[n]).ravel()), GRAD_TOL, 1e-7)
              for n, g in grads.items()}
    main = set(g_opt.names)
    norms = [float(np.sqrt(sum(np.sum(np.square(np.asarray(d[n], np.float64)))
                               for n in main))) for d in (grads, want)]
    alone = port_step(snap, grads=want)["ratios"]
    upd_ratio, name = got["ratios"]["update"]
    g, w = grads[name], np.asarray(want[name]).reshape(grads[name].shape)
    before = np.asarray(snap["before"]["params"][name]).reshape(g.shape)
    after = np.asarray(snap["after"]["params"][name]).reshape(g.shape)
    new = dict(zip(g_opt.names, g_opt.params))[name].detach().numpy()
    miss = (new - after) ** 2
    flip = np.sign(g) != np.sign(w)
    return {"step": os.path.basename(path), "update_ratio": upd_ratio, "tensor": name,
            "grad_ratio": {"worst": sorted(ratios.items(), key=lambda kv: -kv[1])[:8],
                           "over_1": sum(r > 1.0 for r in ratios.values()),
                           "tensors": len(ratios), "of_worst_update_tensor": ratios[name]},
            "clip_norm": {"port": norms[0], "jax": norms[1]},
            "float64": {"jax_f32": against_f64(want), "port_f32_forced": against_f64(g32),
                        "relu_sign_flips_f32_vs_f64": int(sum((a != b).sum()
                                                             for a, b in zip(s32, s64))),
                        "relu_outputs": int(sum(a.size for a in s64))},
            "optimizers_on_jax_grads": {k: [r, n] for k, (r, n) in alone.items()},
            "worst_update_tensor": {
                "elements": int(g.size), "sign_flips": int(flip.sum()),
                "share_of_update_error_on_sign_flips": float(miss[flip].sum() / miss.sum())
                if miss.sum() > 0 else 0.0,
                "update_rms": float(np.sqrt(np.mean((after - before) ** 2))),
                "grad_rms": float(np.sqrt(np.mean(w ** 2)))}}


def init_spread(cfg: str, work: str, roots, eval_root: str, seed: int) -> dict:
    """The port's initial weights against the JAX trainer's for one seed
    (different draws of what should be the same distributions): over the
    tensors of at least 256 values, the range of the ratio of their
    standard deviations and the largest offset of their means, in units of
    the JAX tensor's standard deviation."""
    from dc_vic_tpu_torch.train.trainer import build_trainer
    from dc_vic_tpu_torch.utils.config import load_config
    opt = _opt(load_config, cfg, f"init_s{seed}", work, roots["jpeg"], eval_root, 1, 1, seed)
    want = _jax_init(opt)
    got = {k: v.numpy() for k, v in build_trainer(opt, device="cpu").model.state_dict().items()}
    ratios, offsets = {}, {}
    for k, v in got.items():
        ref = np.asarray(want[k], np.float64).reshape(v.shape)
        if v.size >= 256 and ref.std() > 0:
            ratios[k] = float(v.std() / ref.std())
            offsets[k] = float(abs(v.mean() - ref.mean()) / ref.std())
    lo, hi = min(ratios, key=ratios.get), max(ratios, key=ratios.get)
    far = max(offsets, key=offsets.get)
    return {"tensors": len(got), "compared": len(ratios),
            "std_ratio_min": [lo, ratios[lo]], "std_ratio_max": [hi, ratios[hi]],
            "mean_offset_max": [far, offsets[far]]}


def _merge(path: str, runs: dict) -> None:
    """Add ``runs`` to the summary at ``path`` (runs of other processes kept)."""
    held = {}
    if os.path.exists(path):
        with open(path) as f:
            held = json.load(f)
    held.update(runs)
    with open(path, "w") as f:
        json.dump(held, f, indent=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=600)
    p.add_argument("--eval_step", type=int, default=100)
    p.add_argument("--out", required=True)
    p.add_argument("--runs", default="jax_jpeg,jax_lossless,port_jpeg,port_lossless",
                   help="which runs, comma-separated (portjaxinit_{jpeg,lossless}, "
                        "portreplay_{jpeg,lossless}, jaxulp{1,2,3}_jpeg too)")
    p.add_argument("--init_stats", action="store_true",
                   help="also compare the two packages' initial weights (init_spread)")
    p.add_argument("--seed", type=int, default=0,
                   help="the trainers' seed (init, batches, noise); the data's stays 0")
    p.add_argument("--snapshots", default=None,
                   help="save every SNAP_EVERY-th JAX step of the portreplay runs here")
    p.add_argument("--check_along", default=None,
                   help="take the steps saved under this directory again in the port")
    p.add_argument("--bisect", default=None,
                   help="take one saved step (.npz) apart: gradients, clip, optimizers")
    args = p.parse_args(argv)
    import torch
    torch.set_num_threads(THREADS)
    from dc_vic_tpu_torch.tools import soak
    from test_torch_soak import _small_configs

    os.makedirs(args.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="soak_parity_")
    summary_path = os.path.join(args.out, "summary.json")
    summary = {}
    try:
        cfg = _small_configs(work)["rd"]
        if args.check_along:
            for sub in sorted(os.listdir(args.check_along)):
                key = f"check_along_{sub}"
                summary[key] = check_along(cfg, os.path.join(args.check_along, sub))
                print(key, json.dumps({k: summary[key][k] for k in ("steps", "held", "worst")}),
                      flush=True)
                _merge(summary_path, {key: summary[key]})
        if args.bisect:
            key = "bisect_" + "_".join(args.bisect.rstrip("/").split("/")[-2:])[:-len(".npz")]
            summary[key] = bisect(cfg, args.bisect)
            print(key, json.dumps(summary[key]), flush=True)
            _merge(summary_path, {key: summary[key]})
        runs = list(filter(None, args.runs.split(",")))
        if not (runs or args.init_stats):
            return summary
        jpeg_root, eval_root = _script().make_synthetic_dataset(
            os.path.join(work, "tpu"), size=SIZE)
        npy_root, _ = soak.make_synthetic_dataset(os.path.join(work, "port"), size=SIZE)
        roots = {"jpeg": jpeg_root, "lossless": _lossless(npy_root, os.path.join(work, "png"))}
        if args.init_stats:
            summary[f"init_s{args.seed}"] = init_spread(cfg, work, roots, eval_root, args.seed)
            print(json.dumps(summary[f"init_s{args.seed}"]), flush=True)
            _merge(summary_path, {f"init_s{args.seed}": summary[f"init_s{args.seed}"]})
        for run_name in runs:
            side, data = run_name.split("_")
            name = f"{run_name}_s{args.seed}"
            summary[name] = run(side, data, cfg, work, roots, eval_root, args.iters,
                                args.eval_step, args.seed, args.out, args.snapshots)
            summary[name].update(size=SIZE, eval_step=args.eval_step, seed=args.seed)
            print(name, json.dumps({k: v for k, v in summary[name].items()
                                    if k not in ("iters", "last_loss")}), flush=True)
            _merge(summary_path, {name: summary[name]})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return summary


if __name__ == "__main__":
    main()
