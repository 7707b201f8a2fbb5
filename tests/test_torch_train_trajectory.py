"""A sequence of stage 1_1 RD steps against the JAX package's: the step and
both optimizers held over eight updates, not one.

The JAX side is ``dc_vic_tpu/train/steps.py::make_rd_step``, jitted once,
on ``tiny_config(use_beta=False)``; the port's is ``train/steps.py::rd_step``
with the optimizers its trainer builds (``main_mask``/``aux_mask``). Both
start from the JAX model's own seeded init (carried by
``export_state_dict``) and take the same numpy batches (2 x 64 x 64) and
the same noise: each JAX step's draws are recorded by a jitted forward on
the step's own model key (the draws depend on the key alone) and replayed
through ``codec.ops.Noise(draws=...)``.

The losses and the optimizers are config/exp1_stage1_1.yaml's (Adam 1e-4,
clip 1.0, aux Adam 1e-3) without the main rate's warm-up (a tenth of 1e-4
rising over 50,000 steps), so that eight steps move the weights by about
1e-3. At ten times that rate both packages' estimator argmax flips a token
by the fourth step and from there the two trajectories part: the loss is
not continuous in the weights there, so no tolerance holds a longer or
faster run.

Held: every step's loss terms (atol = rtol = 1e-3, the single-step
tests'); after the last step, every trained tensor's motion from the start
(relative L2 error ``MOTION_TOL`` of the JAX tensor's motion, + 1e-7; the
biases whose gradient is zero by construction, which Adam moves by
rounding noise, within the rate's reach in both), the quantiles the aux
optimizer trains, and the Adam step counts. Besides, the two packages'
training loaders give the same batches for one seed (order, crops, flips).

States the run has really reached (moved quantiles, grown second moments,
the warm-up part way up, the rate at 1e-3) are held one step at a time by
``tests/test_torch_train_along_reference.py``, which carries the JAX
run's whole training state into the port at each snapshot.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from helpers import tiny_config
from train_helpers import TOL, _nchw, _port_layout, recording, zero_by_construction

from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import export_state_dict
from dc_vic_tpu.train import optim as jax_optim
from dc_vic_tpu.train.losses import build_loss as jax_build_loss
from dc_vic_tpu.train.steps import BetaPolicy as JaxPolicy
from dc_vic_tpu.train.steps import TrainState as JaxState
from dc_vic_tpu.train.steps import make_rd_step
from dc_vic_tpu_torch.codec.ops import Noise
from dc_vic_tpu_torch.models import build_comp_model
from dc_vic_tpu_torch.models.convert import load_reference_state_dict
from dc_vic_tpu_torch.train import steps as port_steps
from dc_vic_tpu_torch.train.losses import build_loss
from dc_vic_tpu_torch.train.optim import aux_mask, build_optimizer, main_mask, masked_params
from dc_vic_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 8
MOTION_TOL = 1e-3      # relative L2 error of the port's motion from the start
G_OPT = {"type": "Adam", "lr": 1e-4}


def _stage():
    opt = load_config(os.path.join(ROOT, "config", "exp1_stage1_1.yaml"), is_train=True)
    losses = {k: dict(v) for k, v in dict(opt["loss"]).items()}
    optim = dict(opt["optim"])
    return losses, optim["clip_max_norm"], dict(optim["aux_optimizer"])


@pytest.fixture(scope="module")
def runs():
    """Both packages' eight steps: (JAX terms, port terms, JAX params at
    start and end, the port's model and optimizers)."""
    losses_cfg, clip, aux_cfg = _stage()
    cfg = tiny_config(use_beta=False)
    m = jax_build(cfg).module
    params = jax.jit(lambda r: m.init({"params": r}, jnp.zeros((1, 64, 64, 3)),
                                      is_train=False))(jax.random.PRNGKey(0))
    g_tx = jax_optim.build_optimizer(dict(G_OPT), None, clip)
    aux_tx = jax_optim.build_optimizer(dict(aux_cfg), None, None)
    jlosses = {k: jax_build_loss(v) for k, v in losses_cfg.items()}
    policy = JaxPolicy(use_beta=False)
    step = jax.jit(make_rd_step(m, jlosses, g_tx, aux_tx, policy))
    mp = pytest.MonkeyPatch()
    draws = []
    recording(mp, draws)

    @jax.jit
    def forward_draws(p, x, rng):
        """The noise the step's forward draws from its model key."""
        del draws[:]
        m.apply(p, x, is_train=True, rng=jax.random.split(rng, 3)[2])
        return list(draws)

    batches = np.random.default_rng(11).uniform(
        -1, 1, (STEPS, 2, 64, 64, 3)).astype(np.float32)
    state = JaxState(params=params, g_opt=g_tx.init(params), aux_opt=aux_tx.init(params),
                     step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(7))
    jax_terms, all_draws = [], []
    try:
        for x in batches:
            all_draws.append([np.asarray(d) for d in forward_draws(state.params, x,
                                                                   state.rng)])
            state, terms = step(state, jnp.asarray(x))
            jax_terms.append(jax.tree.map(float, terms))
    finally:
        mp.undo()

    port = build_comp_model(cfg, device="cpu").module
    load_reference_state_dict(port, export_state_dict(params))
    names = [n for n, _ in port.named_parameters()]
    train, aux = main_mask(names), aux_mask(names)
    for n, p in port.named_parameters():
        p.requires_grad_(train[n] or aux[n])
    g_opt = build_optimizer(masked_params(port, train), dict(G_OPT), None, clip)
    aux_opt = build_optimizer(masked_params(port, aux), dict(aux_cfg))
    pstate = port_steps.TrainState(model=port, g_opt=g_opt, aux_opt=aux_opt,
                                   generator=torch.Generator().manual_seed(0))
    plosses = {k: build_loss(v) for k, v in losses_cfg.items()}
    port_terms = []
    for x, d in zip(batches, all_draws):
        replay = Noise(draws=[_port_layout(a) for a in d])
        mp.setattr(port_steps, "Noise", lambda generator: replay)
        try:
            t = port_steps.rd_step(pstate, _nchw(x), plosses,
                                   port_steps.BetaPolicy(use_beta=False))
        finally:
            mp.undo()
        port_terms.append({k: float(v) for k, v in t.items()})
    return dict(jax_terms=jax_terms, port_terms=port_terms, draws=all_draws,
                start=export_state_dict(params), end=export_state_dict(state.params),
                jax_counts=state, port=port, train=train, aux=aux, pstate=pstate)


def test_every_step_s_loss_terms_match_jax(runs):
    """Each of the eight steps: the rate, distortion, LPIPS-proxy and VQ-code
    terms, the total, bpp, qbpp, the VQ accuracy and the aux loss; no step
    skipped on either side."""
    assert len(runs["jax_terms"]) == len(runs["port_terms"]) == STEPS
    assert [len(d) for d in runs["draws"]] == [7] * STEPS     # z, then six y slices
    for i, (want, got) in enumerate(zip(runs["jax_terms"], runs["port_terms"])):
        assert set(want) == set(got), i
        assert want["skipped"] == got["skipped"] == 0.0, i
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, **TOL, err_msg=f"step {i}: {k}")


def test_trained_tensors_after_the_last_step_match_jax(runs):
    """Every tensor the main optimizer trains, and the quantiles the aux
    optimizer trains, after eight steps: the motion from the common start
    agrees with the JAX motion; frozen tensors have not moved."""
    port, start, end = runs["port"], runs["start"], runs["end"]
    zero = zero_by_construction(port)
    moved = 0
    for n, p in port.named_parameters():
        got = p.detach().numpy()
        want = np.asarray(end[n]).reshape(got.shape)
        init = np.asarray(start[n]).reshape(got.shape)
        if not (runs["train"][n] or runs["aux"][n]):
            np.testing.assert_array_equal(got, init, err_msg=n)
            np.testing.assert_array_equal(want, init, err_msg=n)
            continue
        if n in zero:
            for w in (got, want):
                assert np.abs(w - init).max() <= STEPS * G_OPT["lr"], n
            continue
        d_got, d_want = (got - init).ravel(), (want - init).ravel()
        err, ref = np.linalg.norm(d_got - d_want), np.linalg.norm(d_want)
        assert ref > 0, f"{n} did not move"
        assert err <= MOTION_TOL * ref + 1e-7, f"{n}: relative motion error {err / ref:.3e}"
        moved += 1
    assert runs["aux"]["entropy_model_z.quantiles"]
    assert moved == sum(runs["train"].values()) + sum(runs["aux"].values()) - len(zero)


def test_optimizer_counts_follow_the_steps(runs):
    """Both optimizers counted eight updates, as optax's Adam states did."""
    pstate = runs["pstate"]
    assert pstate.step == STEPS
    assert int(pstate.g_opt.count) == int(pstate.aux_opt.count) == STEPS
    counts = [int(np.asarray(leaf)) for leaf in jax.tree.leaves(
        (runs["jax_counts"].g_opt, runs["jax_counts"].aux_opt))
        if np.ndim(leaf) == 0 and np.asarray(leaf).dtype.kind in "iu"]
    assert counts and set(counts) == {STEPS}


def test_loaders_draw_the_same_batches(tmp_path):
    """The two packages' training loaders on the same files and seed: the
    same order, crops (some images smaller than the crop, reflect-padded)
    and flips, pixel for pixel, over two epochs. The trainers' batches do
    not part; what differs between the packages' runs is their noise
    streams (and, unless carried, their initial weights)."""
    from PIL import Image

    from dc_vic_tpu.data.datasets import OpenImageImageDataset as JaxDataset
    from dc_vic_tpu.data.loader import HostDataLoader as JaxLoader
    from dc_vic_tpu_torch.data.datasets import OpenImageImageDataset
    from dc_vic_tpu_torch.data.loader import HostDataLoader
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "train_0")
    for i, (h, w) in enumerate([(80, 96), (64, 64), (72, 60), (100, 70), (66, 90), (50, 81)]):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            tmp_path / "train_0" / f"img{i}.png")
    loaders = [cls(ds(str(tmp_path), subset_list=[0], image_size=64), batch_size=2,
                   num_workers=2, seed=3)
               for ds, cls in ((JaxDataset, JaxLoader), (OpenImageImageDataset, HostDataLoader))]
    for epoch in range(2):
        pairs = zip(*(ld.epoch_batches(epoch) for ld in loaders))
        for want, got in pairs:
            assert want["paths"] == got["paths"]
            np.testing.assert_array_equal(got["real_images"], want["real_images"])
