"""The GAN cell at the tiny size on the CPU: a sound run of the program
comes out correct against the plain reference (``reference/gan.py``), and a
run with the step broken underneath comes out not correct, once for each
fault the cell can have; the traced run reads the discriminator's host
span. The harness's look for a card is skipped; everything else is the
benchmark's own run."""
import time
from unittest import mock

import pytest

from portbench import harness, run
from portbench.tests import tiny
from portbench.tests.test_portbench_faults import few_threads  # noqa: F401 (a fixture)

GAN = "stage1_3_f32.gan_256_b6"
NDF = 64
STARTED = []        # the patches a fault started, stopped after its run
LIMITS = {"loss_gap": {"limit": 1e-4}, "d_loss_gap": {"limit": 1e-4},
          "grad_gap": {"limit": 1e-4}, "grad_vec_gap": {"limit": 1e-3},
          "update_gap": {"limit": 0.2},
          "token_flips": {"limit": 0.005}, "gt_flips": {"limit": 0.005},
          "y_flips": {"limit": 0.005}}


def gan_cell():
    """The cell with the tiny subnet, 64 x 64 crops and the published
    discriminator (ndf 64): at ndf 8 the fakes' gradient that the
    attached-fakes fault sends into the generator stays under the tiny
    run's limits."""
    with mock.patch.dict(tiny.SMALL, {"gan_steps": dict(checked_steps=3, trace_steps=2)}):
        cell = tiny.tiny_cell(GAN, LIMITS)
    cell.config["model_config"]["discriminator"]["ndf"] = NDF
    return cell


def measure(hooks=None, traced=False):
    line, checks = run.measure(gan_cell(), 4_000_000_013, 0.1, traced, "cpu",
                               harness.SetupClock(time.time()), hooks)
    return harness.json.loads(line), {c.name: c for c in checks}


def d_update_skipped(trainer):
    """The discriminator's optimizer never steps."""
    trainer.state.d_opt.step = lambda grads=None, ok=None: None


def half_batch(trainer):
    """Half of the batch left out, the mean taken over the rest."""
    step = trainer.step
    trainer.step = lambda batch: step(batch[:batch.shape[0] // 2])


def fakes_attached(trainer):
    """The fakes not detached in the discriminator's loss: its gradient
    reaches the generator's leaves too (the generator's graph kept for
    it)."""
    import torch
    from dc_vic_tpu_torch.train import steps

    def attached(disc, gan_loss, real, fake, beta_rate, beta_vq, *rest, **kw):
        l_real = gan_loss(disc(real, beta_rate, beta_vq), is_real=True, is_disc=True)
        l_fake = gan_loss(disc(fake, beta_rate, beta_vq), is_real=False, is_disc=True)
        return 0.5 * (l_real + l_fake)
    backward = torch.Tensor.backward

    def keep_graph(self, gradient=None, retain_graph=None, create_graph=False, inputs=None):
        return backward(self, gradient, True, create_graph, inputs)
    for patch in (mock.patch.object(steps, "gan_d_loss", attached),
                  mock.patch.object(torch.Tensor, "backward", keep_graph)):
        patch.start()
        STARTED.append(patch)


def estimator_perturbed(trainer):
    """The estimator's logits perturbed (normal noise of sd 0.5) before the
    argmax that the VQGAN decoder reads."""
    import torch
    gen = torch.Generator().manual_seed(0)
    trainer.model.vq_estimator.register_forward_hook(
        lambda mod, args, out: (out[0], out[1] + 0.5 * torch.randn(
            out[1].shape, generator=gen, dtype=out[1].dtype)))


def test_gan_sound_run_is_correct():
    res, checks = measure()
    assert res["correct"], checks
    assert checks["d_loss_gap"].value < 1e-5


@pytest.mark.parametrize("fault", [d_update_skipped, half_batch, fakes_attached,
                                   estimator_perturbed])
def test_gan_fault_is_caught(fault):
    try:
        res, checks = measure(fault)
    finally:
        while STARTED:
            STARTED.pop().stop()
    assert not res["correct"], checks


def test_gan_traced_run_reads_the_discriminator_s_host_span():
    from dc_vic_tpu_torch.ops import counts
    counts.reset()
    res, _ = measure(traced=True)
    counts.reset()
    m = res["metrics"]
    assert m["d_step_host_ms.gan"]["value"] > 0, m
    assert all(m[k]["value"] > 0 for k in ("forward_host_ms.train", "backward_host_ms.train",
                                             "update_host_ms.train")), m
