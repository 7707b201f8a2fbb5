"""The GAN step's losses and gradients, and the PatchGAN discriminators,
against the JAX package on the same weights, betas and noise.

The JAX side assembles the GAN step's generator loss (``_g_losses`` without
the rate term, plus the adversarial term of ``DualBetaCondTamingNLayer
Discriminator``'s logits on the fakes, entropy path frozen) and the
discriminator's loss on reals and detached fakes, as
``dc_vic_tpu/train/steps.py::make_gan_step`` does, under ``jax.jit`` of
``jax.value_and_grad``; the noise draws are recorded and replayed in the
port. Discriminator weights cross with ``models/convert.py::
discriminator_state_dict``. Losses agree within atol = rtol = 1e-3; each
trained tensor's gradient within a relative L2 error of 1e-3 (+1e-7); the
few conv biases whose gradient is zero in exact arithmetic
(``train_helpers.zero_by_construction``) are held below 1e-3 of their
weight's gradient in both packages instead.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from helpers import tiny_config
from train_helpers import (TOL, _nchw, _port_layout, check_gradients, jax_params, recording,
                           zero_by_construction)

from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import export_state_dict
from dc_vic_tpu.models.discriminators import (DualBetaCondTamingNLayerDiscriminator,
                                              TamingNLayerDiscriminator)
from dc_vic_tpu.train.losses import build_loss as jax_build_loss
from dc_vic_tpu.train.steps import BetaPolicy as JaxPolicy
from dc_vic_tpu.train.steps import _g_losses as jax_g_losses
from dc_vic_tpu_torch.codec.ops import Noise
from dc_vic_tpu_torch.models import build_comp_model
from dc_vic_tpu_torch.models import discriminators as port_disc
from dc_vic_tpu_torch.models.convert import discriminator_state_dict, load_reference_state_dict
from dc_vic_tpu_torch.train.losses import build_loss
from dc_vic_tpu_torch.train.optim import main_mask
from dc_vic_tpu_torch.train.steps import BetaPolicy, gan_d_loss, gan_g_losses

LOSSES = {
    "distortion_loss": {"type": "MSELoss", "loss_weight": 50, "normalize_img": True,
                        "mse_scale": "0_1"},
    "perceptual_loss": {"type": "LPIPSLoss", "net": "alex", "loss_weight": 1.0},
    "gan_loss": {"type": "VanillaGANLoss", "loss_weight": 0.01},
    "code_distortion_loss": {"type": "VanillaMSELoss", "loss_weight": 1.0},
    "code_ce_loss": {"type": "CrossEntropyLoss", "loss_weight": 0.5},
}
DISC = dict(ndf=8, n_layers=3, cond_ch=4, L=4, norm_type="none", max_beta_1=3.0,
            max_beta_2=3.5)
POLICY = dict(use_beta=True, sample_batch_beta=True, weight_type="exp")


@pytest.fixture(scope="module")
def gan():
    mp = pytest.MonkeyPatch()
    cfg = tiny_config()
    m = jax_build(cfg).module
    params = jax_params(m, cfg)
    disc = DualBetaCondTamingNLayerDiscriminator(**DISC)
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    br, bv = np.array([0.7, 2.9], np.float32), np.array([3.4, 0.2], np.float32)
    d_params = jax.jit(lambda r: disc.init(r, jnp.asarray(x), br, bv))(jax.random.PRNGKey(4))
    d_params = jax.tree.map(lambda a: a + 0.01, d_params)     # nonzero biases
    losses = {k: jax_build_loss(v) for k, v in LOSSES.items()}
    policy = JaxPolicy(**POLICY)
    draws = []
    recording(mp, draws)

    def g_loss_fn(p, dp, x, br, bv, key):
        del draws[:]
        out = m.apply(p, x, br, bv, is_train=True, rng=key, fix_entropy_models=True)
        total, terms = jax_g_losses(m, losses, out, x, br, bv, policy, include_rate=False)
        terms["adv"] = losses["gan_loss"](disc.apply(dp, out["fake_images"], br, bv),
                                          is_real=True, is_disc=False)
        return total + terms["adv"], (out, terms, list(draws))

    def d_loss_fn(dp, real, fake, br, bv):
        l_real = losses["gan_loss"](disc.apply(dp, real, br, bv), is_real=True, is_disc=True)
        l_fake = losses["gan_loss"](disc.apply(dp, fake, br, bv), is_real=False, is_disc=True)
        return 0.5 * (l_real + l_fake)

    try:
        (g_total, (out, terms, got)), g_grads = jax.jit(jax.value_and_grad(
            g_loss_fn, has_aux=True))(params, d_params, x, br, bv, jax.random.PRNGKey(8))
        d_total, d_grads = jax.jit(jax.value_and_grad(d_loss_fn))(
            d_params, x, jax.lax.stop_gradient(out["fake_images"]), br, bv)
    finally:
        mp.undo()
    port = build_comp_model(cfg, device="cpu").module
    load_reference_state_dict(port, export_state_dict(params))
    pd = port_disc.DualBetaCondTamingNLayerDiscriminator(**DISC)
    pd.load_state_dict({k: torch.tensor(v) for k, v in
                        discriminator_state_dict(jax.tree.map(np.asarray, d_params)).items()})
    return dict(x=x, br=br, bv=bv, g_total=float(g_total), d_total=float(d_total),
                terms=jax.tree.map(float, terms), fake=np.asarray(out["fake_images"]),
                draws=[np.asarray(d) for d in got], g_grads=export_state_dict(g_grads),
                d_grads=discriminator_state_dict(jax.tree.map(np.asarray, d_grads)),
                port=port, disc=pd)


def test_gan_losses_and_gradients_match_jax(gan):
    """The generator's loss and its gradients (GAN-trainable parameters
    only, the entropy path frozen), then the discriminator's loss and its
    gradients on the reals and the detached fakes."""
    port, disc = gan["port"], gan["disc"]
    names = [n for n, _ in port.named_parameters()]
    trained = main_mask(names, gan_stage=True)
    for n, p in port.named_parameters():
        p.requires_grad_(trained[n])
    losses = {k: build_loss(v) for k, v in LOSSES.items()}
    x = _nchw(gan["x"])
    br, bv = torch.from_numpy(gan["br"]), torch.from_numpy(gan["bv"])
    noise = Noise(draws=[_port_layout(d) for d in gan["draws"]])
    disc.requires_grad_(False)
    g_total, terms, out = gan_g_losses(port, disc, losses, x, br, bv, BetaPolicy(**POLICY),
                                       noise)
    g_total.backward()
    disc.requires_grad_(True)
    np.testing.assert_allclose(float(g_total.detach()), gan["g_total"], **TOL)
    for k, v in gan["terms"].items():
        np.testing.assert_allclose(float(terms[k].detach()), v, **TOL, err_msg=k)
    np.testing.assert_allclose(out["fake_images"].detach().permute(0, 2, 3, 1).numpy(),
                               gan["fake"], **TOL)
    assert check_gradients(port, gan["g_grads"], trained,
                           zero_by_construction(port)) == sum(trained.values())
    assert all(p.grad is None for p in disc.parameters())
    d_total = gan_d_loss(disc, losses["gan_loss"], x, out["fake_images"], br, bv)
    d_total.backward()
    np.testing.assert_allclose(float(d_total.detach()), gan["d_total"], **TOL)
    assert check_gradients(disc, gan["d_grads"], {}) == len(list(disc.parameters()))


@pytest.mark.parametrize("norm_type", ["none", "groupnorm", "layernorm", "instancenorm"])
def test_patchgan_trunk_matches_jax(norm_type):
    """TamingNLayerDiscriminator with each data-independent norm: the
    converted weights give the JAX logits within 1e-3."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 64, 64, 11)).astype(np.float32)
    jd = TamingNLayerDiscriminator(ndf=8, n_layers=2, norm_type=norm_type)
    params = jax.jit(jd.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(a.shape).astype(np.float32),
                          params)
    want = np.asarray(jax.jit(jd.apply)(params, jnp.asarray(x)))
    pd = port_disc.TamingNLayerDiscriminator(11, ndf=8, n_layers=2, norm_type=norm_type)
    sd = discriminator_state_dict(jax.tree.map(np.asarray, params))
    pd.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    got = pd(_nchw(x)).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_unported_discriminators_and_trainers_raise():
    from dc_vic_tpu_torch.train.trainer import build_trainer
    for name in ("DualBetaFtTamingNLayerDiscriminator",
                 "OasisDualBetaCondTamingNLayerDiscriminator"):
        with pytest.raises(NotImplementedError, match="queue 1, item 5"):
            port_disc.build_discriminator({"type": name}, device="cpu")
    for name in ("RateDistortionVqCodeTrainer",
                 "DualBetaCondOasisGanDistortionVqFusionTrainer"):
        with pytest.raises(NotImplementedError, match="queue 1, item 5"):
            build_trainer({"trainer": {"type": name}}, device="cpu")
