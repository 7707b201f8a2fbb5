"""Losses, image metrics and optimizers of the port against the JAX
package's twins on seeded numpy inputs.

Losses and SSIM/MS-SSIM within rtol 1e-5; the uint8 metrics (tensor_to_uint8,
PSNR) exactly. Optimizers: the JAX package's optax chains (clip_by_global_norm,
Adam/AdamW/SGD, the schedules, paramwise multipliers, reset_schedule_counts)
fed the same gradients; parameters after one and after three updates
within rtol 1e-6. A whole RD step of the port (main then aux update,
frozen leaves masked) against optax applied to the port's own gradients,
and a non-finite loss that skips the update but advances the step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from helpers import tiny_config

from dc_vic_tpu.metrics import image as jax_image
from dc_vic_tpu.train import losses as jax_losses
from dc_vic_tpu.train import optim as jax_optim
from dc_vic_tpu_torch.metrics import image
from dc_vic_tpu_torch.metrics.feature_nets import LPIPS, load_lpips
from dc_vic_tpu_torch.models import build_comp_model, init_weights
from dc_vic_tpu_torch.train import losses
from dc_vic_tpu_torch.train import optim
from dc_vic_tpu_torch.tools.workload import metric_state_dicts
from dc_vic_tpu_torch.train.steps import BetaPolicy, TrainState, rd_step

RTOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _images(seed, shape=(2, 40, 48, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    return a, np.clip(a + rng.normal(0, 0.2, shape), -1, 1).astype(np.float32)


LOSS_CASES = {
    "RateLoss": ({"loss_weight": 0.5, "reduction": "mean"}, "bpp"),
    "RateLoss-sum": ({"loss_weight": 0.5, "reduction": "sum"}, "bpp"),
    "MSELoss-0_1": ({"loss_weight": 50, "normalize_img": True, "mse_scale": "0_1"}, "img"),
    "MSELoss-0_255": ({"loss_weight": 2, "normalize_img": True}, "img"),
    "MSELoss-fixed": ({"loss_weight": 3}, "img"),
    "VanillaMSELoss": ({"loss_weight": 0.006}, "img"),
    "L1Loss": ({"loss_weight": 1.5}, "img"),
    "MSSSIMLoss": ({"loss_weight": 1.0}, "big"),
    "CrossEntropyLoss": ({"loss_weight": 0.5}, "logits"),
    "FocalCrossEntropyLoss": ({"loss_weight": 0.003, "gamma": 2.0}, "logits"),
    "VanillaGANLoss": ({"loss_weight": 0.01}, "gan"),
    "HingeGANLoss": ({"loss_weight": 0.1}, "gan"),
    "OasisGANLoss": ({"loss_weight": 0.2}, "oasis"),
    "LPIPSLoss": ({"loss_weight": 1.0}, "img"),
    "LPIPSLoss-range_norm": ({"loss_weight": 1.0, "range_norm": True}, "img"),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_matches_jax(case):
    kw, kind = LOSS_CASES[case]
    name = case.split("-")[0]
    jl = jax_losses.build_loss(dict(kw, type=name))
    pl = losses.build_loss(dict(kw, type=name))
    rng = np.random.default_rng(len(case))
    if kind == "bpp":
        bpp = rng.uniform(0, 2, 6).astype(np.float32)
        pairs = [(jl(jnp.asarray(bpp)), pl(torch.tensor(bpp)))]
    elif kind in ("img", "big"):
        a, b = _images(7, (2, 176, 168, 3) if kind == "big" else (2, 40, 48, 3))
        pairs = [(jl(jnp.asarray(a), jnp.asarray(b)), pl(_nchw(a), _nchw(b)))]
    elif kind == "logits":
        logits = rng.normal(0, 2, (2, 6, 5, 12)).astype(np.float32)
        tgt = rng.integers(0, 12, (2, 6, 5)).astype(np.int32)
        pairs = [(jl(jnp.asarray(logits), jnp.asarray(tgt)),
                  pl(_nchw(logits), torch.tensor(tgt)))]
    elif kind == "gan":
        x = rng.normal(0, 2, (2, 7, 7, 1)).astype(np.float32)
        flags = [(True, True), (False, True), (True, False)]
        pairs = [(jl(jnp.asarray(x), is_real=r, is_disc=d), pl(_nchw(x), is_real=r, is_disc=d))
                 for r, d in flags]
    else:
        logits = rng.normal(0, 2, (2, 4, 4, 9)).astype(np.float32)
        tgt = rng.integers(0, 8, (2, 4, 4)).astype(np.int32)
        pairs = [(jl(jnp.asarray(logits), jnp.asarray(tgt), is_disc=d, is_real=r),
                  pl(_nchw(logits), torch.tensor(tgt), is_disc=d, is_real=r))
                 for r, d in [(True, True), (False, True), (True, False)]]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)


def test_uint8_metrics_match_jax_exactly():
    a, b = _images(3)
    np.testing.assert_array_equal(image.tensor_to_uint8(_nchw(a)).transpose(0, 2, 3, 1),
                                  jax_image.tensor_to_uint8(a))
    assert image.calc_psnr(_nchw(a), _nchw(b)) == jax_image.calc_psnr(a, b)
    assert image.calc_psnr(_nchw(a), _nchw(a)) == float("inf")


@pytest.mark.parametrize("shape", [(2, 176, 168, 3), (1, 171, 190, 3)])
def test_ssim_and_ms_ssim_match_jax(shape):
    """Per-image SSIM and MS-SSIM on [0, 1] images (odd sides padded on
    both ends at each scale), and calc_ms_ssim's -1 below 161 px."""
    a, b = _images(5, shape)
    a, b = (a + 1) / 2, (b + 1) / 2
    np.testing.assert_allclose(image.ssim(_nchw(a), _nchw(b)).numpy(),
                               np.asarray(jax_image.ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=RTOL)
    np.testing.assert_allclose(image.ms_ssim(_nchw(a), _nchw(b)).numpy(),
                               np.asarray(jax_image.ms_ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=RTOL)
    a2, b2 = a * 2 - 1, b * 2 - 1
    np.testing.assert_allclose(image.calc_ms_ssim(_nchw(a2), _nchw(b2)),
                               jax_image.calc_ms_ssim(a2, b2), rtol=RTOL)
    assert image.calc_ms_ssim(_nchw(a2[:, :160]), _nchw(b2[:, :160])) == -1.0


def test_load_lpips(tmp_path):
    """None without a path (the LPIPS loss then takes its proxy); with a
    state-dict file, the frozen LPIPS network on the device asked for."""
    assert load_lpips(None) is None
    path = str(tmp_path / "alex.pth")
    torch.save({k: torch.from_numpy(v)
                for k, v in metric_state_dicts(0)["lpips_alex"].items()}, path)
    net = load_lpips(path, device="cpu")
    assert isinstance(net, LPIPS) and not net.training
    assert not any(p.requires_grad for p in net.parameters())
    with pytest.raises(FileNotFoundError):
        load_lpips(str(tmp_path / "missing.pth"), device="cpu")


# ------------------------------------------------------------------ optimizers

SHAPES = {"enc.conv.weight": (4, 3, 3, 3), "enc.conv.bias": (4,), "dec.mlp.weight": (5, 6)}
OPT_CASES = {
    "adam-clip-multistep": ({"type": "Adam", "lr": 1e-2},
                            {"type": "MultiStepLR", "milestones": [2], "gamma": 0.3}, 1.0, 30.0),
    "adam-warmup": ({"type": "Adam", "lr": 1e-3, "b2": 0.99},
                    {"type": "LinearWarmupScheduler", "warmup_iters": 10}, None, 1.0),
    "adam-warmup-multistep": ({"type": "Adam", "lr": 1e-3},
                              {"type": "LinearWarmupMultiStepLR", "warmup_iters": 2,
                               "milestones": [1, 3], "gamma": 0.5}, 0.5, 1.0),
    "adamw-paramwise": ({"type": "AdamW", "lr": 1e-3, "weight_decay": 0.1,
                         "paramwise_opt": {"dec": 0.1, "conv": 3.0}}, None, None, 1.0),
    "sgd-momentum": ({"type": "SGD", "lr": 0.05, "momentum": 0.9}, None, 2.0, 5.0),
}


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    return {n: (rng.normal(0, scale, s)).astype(np.float32) for n, s in SHAPES.items()}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax(case):
    """Parameters after one and after three updates (the schedule crossing
    its boundaries, clipping active where the gradients are scaled up)."""
    opt_cfg, sched, clip, scale = OPT_CASES[case]
    p0 = _grads(0, 1.0)
    jtx = jax_optim.build_optimizer(dict(opt_cfg), sched, clip)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    jstate = jtx.init(jp)
    upd = jax.jit(jtx.update)
    params = {n: torch.nn.Parameter(torch.tensor(v)) for n, v in p0.items()}
    popt = optim.build_optimizer(params, dict(opt_cfg), sched, clip)
    for step in range(3):
        g = _grads(step + 1, scale)
        u, jstate = upd({n: jnp.asarray(v) for n, v in g.items()}, jstate, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, u)
        popt.step([torch.tensor(g[n]) for n in popt.names])
        if step in (0, 2):
            for n in p0:
                np.testing.assert_allclose(params[n].detach().numpy(), np.asarray(jp[n]),
                                           rtol=1e-6, atol=1e-7, err_msg=f"{n} step {step}")
    assert int(popt.count) == int(popt.sched_count) == 3


def test_reset_schedule_counts_matches_optax():
    """A state reloaded with the schedule reset: the next step takes the
    schedule's first rate, Adam's moments and count carried (optax's
    reset_schedule_counts on the same chain)."""
    opt_cfg, sched = {"type": "Adam", "lr": 1e-2}, {"type": "MultiStepLR",
                                                    "milestones": [2], "gamma": 0.1}
    p0 = _grads(0, 1.0)
    jtx = jax_optim.build_optimizer(dict(opt_cfg), sched, 1.0)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    jstate = jtx.init(jp)
    update = jax.jit(jtx.update)
    params = {n: torch.nn.Parameter(torch.tensor(v)) for n, v in p0.items()}
    popt = optim.build_optimizer(params, dict(opt_cfg), sched, 1.0)
    for step in range(4):
        if step == 3:
            jstate = jax_optim.reset_schedule_counts(jstate)
            popt.load_state_dict(optim.reset_schedule_counts(popt.state_dict()))
            assert (int(popt.count), int(popt.sched_count)) == (3, 0)
        g = _grads(step + 1, 1.0)
        u, jstate = update({n: jnp.asarray(v) for n, v in g.items()}, jstate, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, u)
        popt.step([torch.tensor(g[n]) for n in popt.names])
    for n in p0:
        np.testing.assert_allclose(params[n].detach().numpy(), np.asarray(jp[n]), rtol=1e-6)


def test_optimizer_skips_without_a_host_sync():
    """ok=False leaves parameters, moments and both counters exactly as they
    were, whatever the gradients hold; ok=True then steps normally."""
    params = {n: torch.nn.Parameter(torch.tensor(v)) for n, v in _grads(0, 1.0).items()}
    popt = optim.build_optimizer(params, {"type": "Adam", "lr": 1e-2}, None, 1.0)
    popt.step([torch.tensor(g) for g in _grads(1, 1.0).values()])
    before = {k: (v.clone() if torch.is_tensor(v) else {n: t.clone() for n, t in v.items()})
              for k, v in popt.state_dict().items()}
    p_before = {n: p.detach().clone() for n, p in params.items()}
    bad = [torch.full(s, float("nan")) for s in SHAPES.values()]
    popt.step(bad, ok=torch.tensor(False))
    for n, p in params.items():
        assert torch.equal(p, p_before[n])
    after = popt.state_dict()
    for k, v in before.items():
        if torch.is_tensor(v):
            assert torch.equal(after[k], v)
        else:
            assert all(torch.equal(after[k][n], t) for n, t in v.items())
    popt.step([torch.tensor(g) for g in _grads(2, 1.0).values()], ok=torch.tensor(True))
    assert int(popt.count) == 2


@pytest.fixture(scope="module")
def tiny_state():
    spec = build_comp_model(tiny_config(), device="cpu")
    model = spec.module
    init_weights(model, torch.Generator().manual_seed(0))
    names = [n for n, _ in model.named_parameters()]
    main, aux = optim.main_mask(names), optim.aux_mask(names)
    for n, p in model.named_parameters():
        p.requires_grad_(main[n] or aux[n])
    g_cfg = ({"type": "Adam", "lr": 1e-3}, {"type": "MultiStepLR", "milestones": [5]}, 1.0)
    state = TrainState(model=model, generator=torch.Generator().manual_seed(1),
                       g_opt=optim.build_optimizer(optim.masked_params(model, main), *g_cfg),
                       aux_opt=optim.build_optimizer(optim.masked_params(model, aux),
                                                     {"type": "Adam", "lr": 1e-2}))
    step_losses = {k: losses.build_loss(v) for k, v in {
        "rate_loss": {"type": "RateLoss", "loss_weight": 0.5, "reduction": "none"},
        "distortion_loss": {"type": "MSELoss", "loss_weight": 50, "normalize_img": True,
                            "mse_scale": "0_1"},
        "code_ce_loss": {"type": "FocalCrossEntropyLoss", "loss_weight": 0.003}}.items()}
    return state, step_losses, main, aux, g_cfg


def test_rd_step_updates_as_optax(tiny_state):
    """One rd_step: main update (clip, Adam, MultiStepLR) on main_mask's
    parameters, then the aux update on the quantiles, both as optax applies
    them to the port's own gradients (zeros for every other leaf, as the
    JAX step's zero_frozen_grads gives); frozen leaves bit-identical."""
    state, step_losses, main, aux, g_cfg = tiny_state
    model = state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(2)) * 2 - 1
    terms = rd_step(state, x, step_losses, BetaPolicy(sample_batch_beta=True))
    assert float(terms["skipped"]) == 0.0 and state.step == 1
    grads = {n: (p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32))
             for n, p in model.named_parameters()}
    # the ~800 leaves as one vector: the chains are elementwise but for the
    # global norm, which sums the same squares; one small jit per chain
    names = list(before)
    ends = np.cumsum([before[n].numel() for n in names])
    flat = lambda d: jnp.asarray(np.concatenate([np.ravel(d[n]) for n in names]))
    jflat = flat({n: v.numpy() for n, v in before.items()})
    for mask, cfg in ((main, g_cfg), (aux, ({"type": "Adam", "lr": 1e-2}, None, None))):
        tx = jax_optim.build_optimizer(dict(cfg[0]), cfg[1], cfg[2])
        g = flat({n: grads[n] if mask[n] else np.zeros_like(grads[n]) for n in names})
        u, _ = jax.jit(tx.update)(g, tx.init(jflat), jflat)
        jflat = jflat + u
    jp = {n: v.reshape(before[n].shape)
          for n, v in zip(names, np.split(np.asarray(jflat), ends[:-1]))}
    for n, p in model.named_parameters():
        if not (main[n] or aux[n]):
            assert torch.equal(p, before[n]), n
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]), rtol=1e-6,
                                   atol=1e-8, err_msg=n)
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters() if aux[n])


def test_rd_step_skips_a_non_finite_loss(tiny_state):
    """A NaN batch: skipped, every parameter and optimizer counter as it
    was, the step counter advanced."""
    state, step_losses, *_ = tiny_state
    model = state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    counts = (int(state.g_opt.count), int(state.aux_opt.count), state.step)
    x = torch.full((2, 3, 64, 64), float("nan"))
    terms = rd_step(state, x, step_losses, BetaPolicy(sample_batch_beta=True))
    assert float(terms["skipped"]) == 1.0
    assert (int(state.g_opt.count), int(state.aux_opt.count), state.step) == (
        counts[0], counts[1], counts[2] + 1)
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
