"""The OASIS GAN stage and the FiLM discriminator against the JAX package on
the same weights, betas and noise.

The JAX side assembles the OASIS branch of ``dc_vic_tpu/train/steps.py::
make_gan_step``: the generator's loss (``_g_losses`` without the rate term,
plus ``OasisGANLoss`` of ``OasisDualBetaCondTamingNLayerDiscriminator``'s
logits on the fakes, keyed on the batch's token map) and the
discriminator's loss on reals and detached fakes, under ``jax.jit`` of
``jax.value_and_grad``, once with the reals keyed on the generator batch's
token map and once, as ``mc_sampling`` does, on held-out reals keyed on
their own ``vq_encode``. The noise draws are recorded and replayed in the
port; discriminator weights cross with ``models/convert.py::
discriminator_state_dict``. Losses agree within atol = rtol = 1e-3; each
trained tensor's gradient within a relative L2 error of 1e-3 (+1e-7), as in
``tests/test_torch_train_gan.py``. Then the logits of both new
discriminator classes against flax, and a CPU trainer of the stage.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_threads  # noqa: F401
from helpers import tiny_config
from train_helpers import (TOL, _nchw, _port_layout, check_gradients, jax_params, recording,
                           zero_by_construction)

from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import export_state_dict
from dc_vic_tpu.models.discriminators import (DualBetaFtTamingNLayerDiscriminator,
                                              OasisDualBetaCondTamingNLayerDiscriminator)
from dc_vic_tpu.train.losses import build_loss as jax_build_loss
from dc_vic_tpu.train.steps import BetaPolicy as JaxPolicy
from dc_vic_tpu.train.steps import _g_losses as jax_g_losses
from dc_vic_tpu_torch.codec.ops import Noise
from dc_vic_tpu_torch.models import build_comp_model
from dc_vic_tpu_torch.models import discriminators as port_disc
from dc_vic_tpu_torch.models.convert import discriminator_state_dict, load_reference_state_dict
from dc_vic_tpu_torch.train import steps as port_steps
from dc_vic_tpu_torch.train.losses import build_loss
from dc_vic_tpu_torch.train.optim import main_mask
from dc_vic_tpu_torch.train.steps import BetaPolicy, gan_d_loss, gan_g_losses
from dc_vic_tpu_torch.train.trainer import build_trainer
from dc_vic_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSSES = {
    "distortion_loss": {"type": "MSELoss", "loss_weight": 50, "normalize_img": True,
                        "mse_scale": "0_1"},
    "gan_loss": {"type": "OasisGANLoss", "loss_weight": 0.01},
    "code_distortion_loss": {"type": "VanillaMSELoss", "loss_weight": 1.0},
    "code_ce_loss": {"type": "CrossEntropyLoss", "loss_weight": 0.5},
}
# n_layers 2 keeps 64 / 4 = 16 logits a side: resized to the 8 x 8 token grid
OASIS = dict(ndf=8, n_embed=32, n_layers=2, cond_ch=4, L=4, norm_type="none",
             max_beta_1=3.0, max_beta_2=3.5)
POLICY = dict(use_beta=True, sample_batch_beta=True, weight_type="exp")


def _to_port(d_params):
    return {k: torch.tensor(v) for k, v in
            discriminator_state_dict(jax.tree.map(np.asarray, d_params)).items()}


@pytest.fixture(scope="module")
def oasis():
    mp = pytest.MonkeyPatch()
    cfg = tiny_config()
    m = jax_build(cfg).module
    params = jax_params(m, cfg)
    disc = OasisDualBetaCondTamingNLayerDiscriminator(**OASIS)
    rng = np.random.default_rng(5)
    # the generator's batch, then two held-out reals (mc_sampling's second half)
    x, held = (rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2))
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
                                          out["gt_vq_indices"], is_disc=False, is_real=True)
        return total + terms["adv"], (out, terms, list(draws))

    def d_loss_fn(dp, real, fake, br, bv, real_idx, fake_idx):
        l_real = losses["gan_loss"](disc.apply(dp, real, br, bv), real_idx, is_disc=True,
                                    is_real=True)
        l_fake = losses["gan_loss"](disc.apply(dp, fake, br, bv), fake_idx, is_disc=True,
                                    is_real=False)
        return 0.5 * (l_real + l_fake)

    try:
        (g_total, (out, terms, got)), g_grads = jax.jit(jax.value_and_grad(
            g_loss_fn, has_aux=True))(params, d_params, x, br, bv, jax.random.PRNGKey(8))
    finally:
        mp.undo()
    fake, idx = jax.lax.stop_gradient(out["fake_images"]), out["gt_vq_indices"]
    held_idx = m.apply(params, jnp.asarray(held), method=m.vq_encode)[1]
    d_fn = jax.jit(jax.value_and_grad(d_loss_fn))
    d = {False: d_fn(d_params, x, fake, br, bv, idx, idx),
         True: d_fn(d_params, held, fake, br, bv, held_idx, idx)}
    port = build_comp_model(cfg, device="cpu").module
    load_reference_state_dict(port, export_state_dict(params))
    return dict(x=x, held=held, br=br, bv=bv, g_total=float(g_total),
                terms=jax.tree.map(float, terms), fake=np.array(out["fake_images"]),
                idx=np.asarray(idx), held_idx=np.asarray(held_idx),
                draws=[np.asarray(d) for d in got], g_grads=export_state_dict(g_grads),
                d={k: (float(v[0]), discriminator_state_dict(jax.tree.map(np.asarray, v[1])))
                   for k, v in d.items()},
                port=port, d_params=d_params)


def _port_disc(oasis):
    pd = port_disc.OasisDualBetaCondTamingNLayerDiscriminator(**OASIS)
    pd.load_state_dict(_to_port(oasis["d_params"]), strict=True)
    return pd


def test_oasis_g_loss_and_gradients_match_jax(oasis):
    """The generator's loss, its terms (the adversarial one keyed on
    ``gt_vq_indices``) and its gradients, the entropy path frozen and the
    discriminator untouched."""
    port, disc = oasis["port"], _port_disc(oasis)
    names = [n for n, _ in port.named_parameters()]
    trained = main_mask(names, gan_stage=True)
    for n, p in port.named_parameters():
        p.requires_grad_(trained[n])
        p.grad = None
    losses = {k: build_loss(v) for k, v in LOSSES.items()}
    br, bv = torch.from_numpy(oasis["br"]), torch.from_numpy(oasis["bv"])
    noise = Noise(draws=[_port_layout(d) for d in oasis["draws"]])
    disc.requires_grad_(False)
    g_total, terms, out = gan_g_losses(port, disc, losses, _nchw(oasis["x"]), br, bv,
                                       BetaPolicy(**POLICY), noise, oasis=True)
    g_total.backward()
    np.testing.assert_array_equal(out["gt_vq_indices"].numpy(), oasis["idx"])
    np.testing.assert_allclose(float(g_total.detach()), oasis["g_total"], **TOL)
    assert sorted(terms) == sorted(oasis["terms"])
    for k, v in oasis["terms"].items():
        np.testing.assert_allclose(float(terms[k].detach()), v, **TOL, err_msg=k)
    np.testing.assert_allclose(out["fake_images"].detach().permute(0, 2, 3, 1).numpy(),
                               oasis["fake"], **TOL)
    assert check_gradients(port, oasis["g_grads"], trained,
                           zero_by_construction(port)) == sum(trained.values())
    assert all(p.grad is None for p in disc.parameters())


@pytest.mark.parametrize("mc_sampling", [False, True])
def test_oasis_d_loss_and_gradients_match_jax(oasis, mc_sampling):
    """The discriminator's loss and gradients on the JAX fakes: reals keyed
    on the generator batch's token map, or (``mc_sampling``) held-out reals
    keyed on their own ``vq_encode``, as ``gan_step`` derives them."""
    disc = _port_disc(oasis)
    fake_idx = torch.tensor(oasis["idx"])
    if mc_sampling:
        real = _nchw(oasis["held"])
        with torch.no_grad():
            real_idx = oasis["port"].vq_encode(real)[1]
        np.testing.assert_array_equal(real_idx.numpy(), oasis["held_idx"])
    else:
        real, real_idx = _nchw(oasis["x"]), fake_idx
    d_total = gan_d_loss(disc, build_loss(LOSSES["gan_loss"]), real, _nchw(oasis["fake"]),
                         torch.from_numpy(oasis["br"]), torch.from_numpy(oasis["bv"]),
                         real_tokens=real_idx, fake_tokens=fake_idx)
    d_total.backward()
    want, grads = oasis["d"][mc_sampling]
    np.testing.assert_allclose(float(d_total.detach()), want, **TOL)
    assert check_gradients(disc, grads, {}) == len(list(disc.parameters()))


DISCRIMINATORS = {
    "oasis-n_layers2-resized": (OasisDualBetaCondTamingNLayerDiscriminator,
                                port_disc.OasisDualBetaCondTamingNLayerDiscriminator,
                                dict(OASIS, n_layers=2)),
    "oasis-n_layers3": (OasisDualBetaCondTamingNLayerDiscriminator,
                        port_disc.OasisDualBetaCondTamingNLayerDiscriminator,
                        dict(OASIS, n_layers=3)),
    "film-none": (DualBetaFtTamingNLayerDiscriminator,
                  port_disc.DualBetaFtTamingNLayerDiscriminator,
                  dict(ndf=8, n_layers=3, cond_ch=8, L=4, norm_type="none")),
    "film-groupnorm": (DualBetaFtTamingNLayerDiscriminator,
                       port_disc.DualBetaFtTamingNLayerDiscriminator,
                       dict(ndf=32, n_layers=2, cond_ch=8, L=4, norm_type="groupnorm")),
}


@pytest.mark.parametrize("case", sorted(DISCRIMINATORS))
def test_discriminator_logits_match_jax(case):
    """Both new classes on converted (perturbed) weights give the flax
    logits within 1e-3; the OASIS head lands on the token grid, through a
    16 -> 8 nearest resize at n_layers 2 and none at n_layers 3."""
    jax_cls, port_cls, kw = DISCRIMINATORS[case]
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    br, bv = np.array([0.4, 2.2], np.float32), np.array([1.1, 3.3], np.float32)
    jd = jax_cls(**kw)
    params = jax.jit(jd.init)(jax.random.PRNGKey(1), jnp.asarray(x), br, bv)
    params = jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(a.shape).astype(np.float32),
                          params)
    want = np.asarray(jax.jit(jd.apply)(params, jnp.asarray(x), br, bv))
    pd = port_cls(**kw)
    pd.load_state_dict(_to_port(params), strict=True)
    got = pd(_nchw(x), torch.from_numpy(br), torch.from_numpy(bv), y_hat=torch.zeros(1))
    got = got.detach().permute(0, 2, 3, 1).numpy()
    if case.startswith("oasis"):
        assert got.shape == (2, 8, 8, kw["n_embed"] + 1)
    np.testing.assert_allclose(got, want, **TOL)


def test_film_discriminator_reads_its_own_weight_init():
    """``weight_init: false`` gives the FiLM discriminator's convs
    lecun-normal, not N(0, 0.02): the class has no PatchGAN trunk to read
    the flag from."""
    for flag, lo, hi in ((True, 0.018, 0.022), (False, 0.05, 0.15)):
        d = port_disc.build_discriminator({"type": "DualBetaFtTamingNLayerDiscriminator",
                                           "ndf": 8, "weight_init": flag}, device="cpu")
        port_disc.init_discriminator(d, torch.Generator().manual_seed(0))
        std = float(d.convs[1].weight.detach().std())          # fan-in 128: lecun std 0.088
        assert lo < std < hi, (flag, std)


def _oasis_yaml(tmp, load=None):
    """config/exp1_stage1_3.yaml as the OASIS stage at the tiny widths:
    the OASIS trainer with mc_sampling, the OASIS discriminator, the
    OASIS loss; two .npy training images, one evaluation image."""
    tiny = tiny_config().to_plain()
    cfg = {
        "_base_": os.path.join(ROOT, "config", "exp1_stage1_3.yaml"),
        "subnet": dict(tiny["subnet"], _delete_=True),
        "trainer": {"type": "DualBetaCondOasisGanDistortionVqFusionTrainer",
                    "mc_sampling": True},
        "discriminator": dict(OASIS, type="OasisDualBetaCondTamingNLayerDiscriminator",
                              _delete_=True),
        "loss": {"gan_loss": {"type": "OasisGANLoss", "loss_weight": 0.01}},
        "ckpt_root": os.path.join(tmp, "ckpt"), "seed": 0, "exp": "oasis",
        "dataset": {"batch_size": 2,
                    "train_dataset": {"root_dir": os.path.join(tmp, "data"),
                                      "subset_list": [0], "image_size": 64},
                    "eval_dataset": {"root_dir": os.path.join(tmp, "data", "kodak")}},
        "load_checkpoint": dict(load, _delete_=True) if load else None,
    }
    path = os.path.join(tmp, "oasis.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return load_config(path, is_train=True)


def test_oasis_trainer_steps_saves_and_boots_its_discriminator(tmp_path, monkeypatch):
    """The registered trainer on the CPU takes one finite step with
    mc_sampling (the fakes keyed on the first half's token map, the reals
    on the second half's own), saves, and a second trainer booted from the
    checkpoint holds the same discriminator bit for bit."""
    tmp = str(tmp_path)
    rng = np.random.default_rng(0)
    for sub, n in (("train_0", 2), ("kodak", 1)):
        os.makedirs(os.path.join(tmp, "data", sub))
        for i in range(n):
            np.save(os.path.join(tmp, "data", sub, f"img{i}.npy"),
                    rng.integers(0, 256, (72, 80, 3), dtype=np.uint8))
    tr = build_trainer(_oasis_yaml(tmp), device="cpu")
    assert tr.oasis and tr.mc_sampling
    assert isinstance(tr.state.disc, port_disc.OasisDualBetaCondTamingNLayerDiscriminator)
    seen = {}

    def spy(*args, **kw):
        seen.update(kw)
        return gan_d_loss(*args, **kw)
    monkeypatch.setattr(port_steps, "gan_d_loss", spy)
    init = {k: v.clone() for k, v in tr.state.disc.state_dict().items()}
    batch = tr._to_device(next(tr.train_loader.infinite())["real_images"])
    terms = tr.step(batch)
    assert float(terms["skipped"]) == 0 and all(np.isfinite(float(v)) for v in terms.values())
    with torch.no_grad():
        want = [tr.model.vq_encode(batch[i:i + 1])[1] for i in (0, 1)]
    assert torch.equal(seen["fake_tokens"], want[0])
    assert torch.equal(seen["real_tokens"], want[1])
    tr.save(1)
    saved = {k: v.clone() for k, v in tr.state.disc.state_dict().items()}
    booted = build_trainer(_oasis_yaml(tmp, {"exp": "oasis", "iter": 1, "strict": True}),
                           device="cpu")
    got = booted.state.disc.state_dict()
    assert sorted(got) == sorted(saved)
    assert all(torch.equal(got[k], v) for k, v in saved.items())
    assert any(not torch.equal(init[k], v) for k, v in saved.items())
