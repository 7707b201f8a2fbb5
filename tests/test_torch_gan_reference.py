"""The port's GAN step (stages 1_3 and 3, ``train/steps.py::gan_step``)
against the benchmark's plain reference (``portbench/reference/gan.py``),
which imports nothing of the port: stage 1_3's configuration with the tiny
subnet of ``portbench/tests/tiny_model.json`` and a discriminator of ndf 8,
seeded weights, the same rows and the same draws (the step's generator
reseeded alike on both sides), three steps. And the program spans of the
GAN step and of the RD step under a CPU profiler session. No JAX."""
import copy
import json
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from dc_vic_tpu_torch.metrics.feature_nets import load_lpips
from dc_vic_tpu_torch.models import build_comp_model
from dc_vic_tpu_torch.models.discriminators import build_discriminator, init_discriminator
from dc_vic_tpu_torch.ops import counts
from dc_vic_tpu_torch.train import losses, optim
from dc_vic_tpu_torch.train.steps import BetaPolicy, TrainState, gan_step, rd_step
from portbench import weights
from portbench.drivers.gan_steps import port_disc_names
from portbench.drivers.train_steps import lpips_weights
from portbench.reference import dcvic
from portbench.reference.gan import GANStep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, SIZE, STEPS = 2, 64, 3
DRAWS = [1_000_003 + 17 * s for s in range(STEPS)]

# Each tolerance and why. Both sides compute in float32 on the CPU through
# different modules (cuDNN-free convs, a GroupNorm, attention and Swin
# written apart), so their sums round in another order.
# - Loss terms: the first step's terms agree to a few float32 roundings of
#   their size (read: under 3e-7 relative); 2e-5 leaves room for another
#   CPU's vector width and still fails a term computed on half the batch or
#   with the wrong weight (relative gaps of 1e-2 and more).
TERM_RTOL = 2e-5
# - Gradients: per tensor, relative L2 against the larger of the tensor's
#   and the median tensor's reference norm (the benchmark's rule), so that
#   a leaf whose gradient nearly cancels does not turn rounding into a
#   large ratio; read: under 1e-5. 1e-3 is the port's training tests'
#   per-tensor tolerance against JAX.
GRAD_TOL = 1e-3
# - Parameters after three steps: each trained leaf's change, relative L2
#   against the larger of its and the median leaf's reference change.
#   Adam's first updates divide by the gradient's own size, so rounding in
#   an element whose gradient is near zero moves that element by up to a
#   whole step (lr). The conv biases in front of a GroupNorm have a
#   gradient of zero in exact arithmetic (the norm takes their shift out),
#   so theirs is rounding alone and their Adam steps are noise: as in the
#   benchmark's rule, leaves whose first reference gradient is under 1e-3
#   of the median leaf's are left out here (at most a tenth). Read on the
#   rest: under 6e-3; 2e-2 fails a skipped update (1.0) and a lost
#   discriminator step (1.0).
UPDATE_TOL = 2e-2


def _opt():
    with open(os.path.join(ROOT, "portbench", "configs", "exp1_stage1_3.f32.json")) as f:
        opt = json.load(f)["model_config"]
    with open(os.path.join(ROOT, "portbench", "tests", "tiny_model.json")) as f:
        opt["subnet"] = json.load(f)["subnet"]
    opt["discriminator"]["ndf"] = 8
    return opt


def _gap(mine, ref):
    """Per leaf: |mine - ref| over the larger of |ref| and the median
    leaf's |ref| (L2 norms)."""
    d = np.array([float(torch.linalg.vector_norm(a - b)) for a, b in zip(mine, ref)])
    r = np.array([float(torch.linalg.vector_norm(b)) for b in ref])
    return d / np.maximum(r, np.median(r))


def _port_state(opt, w, seed):
    model = build_comp_model(opt, device="cpu").module.train()
    model.load_state_dict(w)
    names = [n for n, _ in model.named_parameters()]
    main = optim.main_mask(names, gan_stage=True)
    for n, p in model.named_parameters():
        p.requires_grad_(main[n])
    o = opt["optim"]
    disc = build_discriminator(dict(opt["discriminator"]), "cpu")
    init_discriminator(disc, torch.Generator().manual_seed(seed))
    return TrainState(
        model=model, generator=torch.Generator(),
        g_opt=optim.build_optimizer(optim.masked_params(model, main), o["g_optimizer"],
                                    o["g_scheduler"], o["clip_max_norm"]),
        disc=disc,
        d_opt=optim.build_optimizer(dict(disc.named_parameters()), o["d_optimizer"],
                                    o["d_scheduler"], o["clip_max_norm"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three steps of each side from the same state; the first step's terms
    and gradients, the changes after the last."""
    torch.manual_seed(0)
    opt = _opt()
    with torch.device("meta"):
        shape = dcvic.DCVIC(opt)
    w = weights.make_weights(shape, 2_000_001, "cpu", 0.55)
    lp = lpips_weights(2_000_002, "cpu")
    path = str(tmp_path_factory.mktemp("lpips") / "alex.pt")
    torch.save(lp, path)
    state = _port_state(opt, w, 2_000_003)
    # the port's seeded discriminator, handed to the reference by name
    d_names = port_disc_names(opt["discriminator"]["n_layers"])
    d_sd = state.disc.state_dict()
    disc0 = {k: d_sd[v].detach().clone() for k, v in d_names.items()}
    step_losses = {k: losses.build_loss(v) for k, v in opt["loss"].items()}
    policy = BetaPolicy(max_beta_rate=3.0, max_beta_vq=3.5, sample_batch_beta=True,
                        weight_type="exp")
    lpips_fn = load_lpips(path, "alex", "cpu")
    g = torch.Generator().manual_seed(2_000_004)
    batches = [torch.rand(B, 3, SIZE, SIZE, generator=g) * 2 - 1 for _ in range(STEPS)]

    port = {"terms": None}
    for s, x in enumerate(batches):
        state.generator.manual_seed(DRAWS[s])
        terms = gan_step(state, x, step_losses, policy, lpips_fn=lpips_fn)
        if s == 0:
            port["terms"] = {k: float(v) for k, v in terms.items()}
            d_mu = dict(zip(state.d_opt.names, state.d_opt.mu))
            port["grads"] = [m / (1 - state.g_opt.b1)
                             for m in state.g_opt.mu + [d_mu[d_names[k]] for k in disc0]]
    params = dict(state.model.named_parameters())
    d_params = dict(state.disc.named_parameters())
    port["change"] = ([params[n].detach() - w[n] for n in state.g_opt.names]
                      + [d_params[d_names[k]].detach() - v for k, v in disc0.items()])
    port["names"] = list(state.g_opt.names)

    ref_step = GANStep(opt, w, lp, disc0, "cpu")
    ref = {}
    for s, x in enumerate(batches):
        out = ref_step.step(x, DRAWS[s])
        if s == 0:
            ref["terms"], ref["grads"] = out, out["grads"]
    p = dict(ref_step.model.named_parameters())
    ref["change"] = ([p[n].detach() - w[n] for n in ref_step.g_names]
                     + [q.detach() - disc0[k] for k, q in ref_step.disc.named_parameters()])
    ref["names"] = ref_step.g_names
    return port, ref, state


def test_gan_step_trains_the_same_leaves(runs):
    port, ref, state = runs
    assert port["names"] == ref["names"]
    assert {n.split(".")[0] for n in port["names"]} == {"decoder", "vq_estimator",
                                                       "fusion_module"}
    assert len(port["grads"]) == len(ref["grads"]) == len(port["names"]) + len(
        list(state.disc.parameters()))


@pytest.mark.parametrize("term", ["distortion", "perceptual", "code_distortion", "code_ce",
                                  "adv", "total", "d_loss"])
def test_gan_step_first_terms(runs, term):
    port, ref, _ = runs
    assert port["terms"][term] == pytest.approx(ref["terms"][term], rel=TERM_RTOL)
    assert port["terms"]["skipped"] == 0.0 and ref["terms"]["ok"]


def test_gan_step_first_gradients_of_both_optimizers(runs):
    port, ref, state = runs
    gaps = _gap(port["grads"], ref["grads"])
    n_g = len(port["names"])
    assert gaps[:n_g].max() < GRAD_TOL, gaps[:n_g].max()
    assert gaps[n_g:].max() < GRAD_TOL, gaps[n_g:].max()
    # the discriminator's gradient is not zero: its half really ran
    assert all(float(torch.linalg.vector_norm(g)) > 0 for g in ref["grads"][n_g:])


def test_gan_step_parameters_after_three_steps(runs):
    port, ref, _ = runs
    g = np.array([float(torch.linalg.vector_norm(t)) for t in ref["grads"]])
    keep = g >= 1e-3 * np.median(g)
    assert keep.sum() >= 0.9 * len(keep)
    gaps = _gap(port["change"], ref["change"])[keep]
    assert gaps.max() < UPDATE_TOL, gaps.max()
    n_g = len(port["names"])
    assert all(float(torch.linalg.vector_norm(c)) > 0 for c in ref["change"][n_g:])


def _span_entries(fn):
    counts.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    got = {k: n for k, (_, n) in counts.spans(True).items()
           if k.startswith("train.") or k == "nn.discriminator"}
    counts.reset()
    return got


def test_gan_and_rd_step_spans(runs):
    """Under a profiler session a GAN step enters ``nn.discriminator`` three
    times (the fakes through the frozen discriminator, then the reals and
    the detached fakes) and ``train.d_step`` once, and keeps the generator's
    ``train.forward`` and ``train.backward``; the RD step's spans are as
    they were."""
    _, _, state = runs
    opt = _opt()
    step_losses = {k: losses.build_loss(v) for k, v in opt["loss"].items()}
    x = torch.rand(B, 3, SIZE, SIZE, generator=torch.Generator().manual_seed(5)) * 2 - 1
    policy = BetaPolicy(sample_batch_beta=True, weight_type="exp")
    assert _span_entries(lambda: gan_step(state, x, step_losses, policy)) == {
        "train.forward": 1, "train.backward": 1, "train.d_step": 1, "train.update": 1,
        "nn.discriminator": 3}

    names = [n for n, _ in state.model.named_parameters()]
    aux = optim.aux_mask(names)
    rd_state = copy.copy(state)
    rd_state.aux_opt = optim.build_optimizer(optim.masked_params(state.model, aux),
                                             {"type": "Adam", "lr": 1e-3})
    rd_losses = {"distortion_loss": losses.build_loss(
        {"type": "MSELoss", "loss_weight": 50})}
    assert _span_entries(lambda: rd_step(rd_state, x, rd_losses, policy)) == {
        "train.forward": 1, "train.backward": 1, "train.update": 1}
