"""The port's training forward and the RD step's gradients against the JAX
model's, on the same weights, betas and noise.

The JAX side runs ``DCVICModel.__call__(is_train=True)`` and ``_g_losses``
under one ``jax.jit(jax.value_and_grad(...))``; ``jax.random.uniform`` and
``jax.random.gumbel`` are wrapped to record their draws in call order (z,
the six y slices, the Gumbel noise), which the port replays through
``codec.ops.Noise``. The config is the tiny one with ``gumbel_sampling`` on,
so that the estimator's logits reach the decoder (and K2's gradient runs).
Outputs agree within atol = rtol = 1e-3 (the model tests' tolerance); each
trained parameter's gradient within a relative L2 error of 1e-3 (+1e-7), but
for the conv biases whose gradient is zero in exact arithmetic
(``train_helpers.zero_by_construction``), held below 1e-3 of their weight's
gradient in both packages.
"""
import jax
import numpy as np
import pytest
import torch

from helpers import tiny_config
from train_helpers import (TOL, _nchw, _port_layout, check_gradients, jax_params, recording,
                           zero_by_construction)

from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import PathMapper, export_state_dict
from dc_vic_tpu.train import optim as jax_optim
from dc_vic_tpu.train.losses import build_loss as jax_build_loss
from dc_vic_tpu.train.steps import BetaPolicy as JaxPolicy
from dc_vic_tpu.train.steps import _g_losses as jax_g_losses
from dc_vic_tpu_torch.codec.ops import Noise
from dc_vic_tpu_torch.models import build_comp_model
from dc_vic_tpu_torch.models.convert import load_reference_state_dict
from dc_vic_tpu_torch.train.losses import build_loss
from dc_vic_tpu_torch.train.optim import aux_mask, main_mask
from dc_vic_tpu_torch.train.steps import BetaPolicy, rd_losses

LOSSES = {
    "rate_loss": {"type": "RateLoss", "loss_weight": 0.5, "reduction": "none"},
    "distortion_loss": {"type": "MSELoss", "loss_weight": 50, "normalize_img": True,
                        "mse_scale": "0_1"},
    "perceptual_loss": {"type": "LPIPSLoss", "net": "alex", "loss_weight": 1.0},
    "code_distortion_loss": {"type": "VanillaMSELoss", "loss_weight": 0.006},
    "code_ce_loss": {"type": "FocalCrossEntropyLoss", "loss_weight": 0.003, "gamma": 2.0},
}
POLICY = dict(use_beta=True, sample_batch_beta=True, weight_type="exp")


def gumbel_config():
    cfg = tiny_config()
    cfg["model"]["gumbel_sampling"] = True
    return cfg


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rd(tmp_path_factory):
    """The JAX RD loss, its outputs, its draws and its gradients, once."""
    mp = pytest.MonkeyPatch()
    cfg = gumbel_config()
    m = jax_build(cfg).module
    params = jax_params(m, cfg)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    br, bv = np.array([2.4, 0.3], np.float32), np.array([1.1, 3.2], np.float32)
    losses = {k: jax_build_loss(v) for k, v in LOSSES.items()}
    policy = JaxPolicy(**POLICY)
    draws = []
    recording(mp, draws)

    def loss_fn(p, x, br, bv, key):
        del draws[:]
        out = m.apply(p, x, br, bv, is_train=True, rng=key)
        total, terms = jax_g_losses(m, losses, out, x, br, bv, policy)
        return total, (out, terms, list(draws))

    try:
        (total, (out, terms, got_draws)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params, x, br, bv,
                                                       jax.random.PRNGKey(5))
        aux, aux_grads = jax.jit(jax.value_and_grad(
            lambda p: m.apply(p, method=m.aux_loss)))(params)
    finally:
        mp.undo()
    port = build_comp_model(cfg, device="cpu").module
    load_reference_state_dict(port, export_state_dict(params))
    return dict(m=m, params=params, x=x, br=br, bv=bv, total=float(total),
                out=jax.tree.map(np.asarray, out), terms=jax.tree.map(float, terms),
                draws=[np.asarray(d) for d in got_draws], grads=export_state_dict(grads),
                aux=float(aux), aux_grads=export_state_dict(aux_grads), port=port, cfg=cfg)


def port_rd(rd, fix_entropy_models=False):
    """The port's RD loss on the JAX run's inputs and draws, backward taken
    through the loss and the aux loss."""
    port = rd["port"]
    names = [n for n, _ in port.named_parameters()]
    train = main_mask(names)
    aux = aux_mask(names)
    for n, p in port.named_parameters():
        p.requires_grad_(train[n] or aux[n])
        p.grad = None
    losses = {k: build_loss(v) for k, v in LOSSES.items()}
    x = _nchw(rd["x"])
    br, bv = torch.from_numpy(rd["br"]), torch.from_numpy(rd["bv"])
    noise = Noise(draws=[_port_layout(d) for d in rd["draws"]])
    if fix_entropy_models:
        out = port(x, br, bv, is_train=True, noise=noise, fix_entropy_models=True)
        return out, None, None
    total, terms, out = rd_losses(port, losses, x, br, bv, BetaPolicy(**POLICY), noise)
    aux_loss = port.aux_loss()
    (total + aux_loss).backward()
    return out, dict(terms, total=total, aux=aux_loss), train


def test_draws_replay_in_order(rd):
    """z's [C, 1, N] draw, six slice draws, the Gumbel draw."""
    shapes = [d.shape for d in rd["draws"]]
    assert len(shapes) == 8 and len(shapes[0]) == 3 and shapes[-1][-1] == 32


def test_training_forward_matches_jax(rd):
    out, terms, _ = port_rd(rd)
    want = rd["out"]
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(nhwc(out["fake_images"]), want["fake_images"], **TOL)
    np.testing.assert_allclose(nhwc(out["out_vq_logits"]), want["out_vq_logits"], **TOL)
    np.testing.assert_allclose(nhwc(out["out_vq_latent"]), want["out_vq_latent"], **TOL)
    np.testing.assert_array_equal(out["gt_vq_indices"].numpy(), want["gt_vq_indices"])
    for key in ("bpp", "qbpp", "bpp_per_sample", "vq_accuracy"):
        np.testing.assert_allclose(out[key].detach().numpy(), want[key], **TOL, err_msg=key)
    for group in ("likelihoods", "q_likelihoods", "quantized_code", "latent_code"):
        for k in ("y", "z"):
            np.testing.assert_allclose(nhwc(out[group][k]), want[group][k], **TOL,
                                       err_msg=f"{group}/{k}")
    for k, v in rd["terms"].items():
        np.testing.assert_allclose(float(terms[k].detach()), v, **TOL, err_msg=k)
    np.testing.assert_allclose(float(terms["total"].detach()), rd["total"], **TOL)
    np.testing.assert_allclose(float(terms["aux"].detach()), rd["aux"], rtol=1e-5)


def test_rd_gradients_match_jax(rd):
    """Every parameter main_mask trains, and the quantiles (aux), against
    jax.grad; frozen parameters get no gradient at all."""
    port = rd["port"]
    _, _, train = port_rd(rd)
    want = dict(rd["grads"])
    want.update({n: g for n, g in rd["aux_grads"].items() if n.endswith("quantiles")})
    trained = {n: t or n.endswith("quantiles") for n, t in train.items()}
    checked = check_gradients(port, want, trained, zero_by_construction(port))
    assert checked == sum(train.values()) + 1


def test_masks_match_jax(rd):
    """main_mask (both stages) and aux_mask on the port's names equal the
    JAX masks carried through the converter's path map."""
    flat = jax.tree_util.tree_flatten_with_path(rd["params"])[0]
    mapper = PathMapper()
    names = [n for n, _ in rd["port"].named_parameters()]
    for gan in (False, True):
        jm = jax_optim.main_mask(rd["params"]["params"], gan_stage=gan)
        jm_flat = dict(jax.tree_util.tree_flatten_with_path(jm)[0])
        want = {}
        for path, _ in flat:
            keys = tuple(k.key for k in path)
            want[mapper.map_path(keys)[0]] = bool(jm_flat[tuple(path[1:])])
        assert main_mask(names, gan_stage=gan) == want
    ja = jax_optim.aux_mask(rd["params"]["params"])
    ja_flat = dict(jax.tree_util.tree_flatten_with_path(ja)[0])
    want = {mapper.map_path(tuple(k.key for k in path))[0]: bool(ja_flat[tuple(path[1:])])
            for path, _ in flat}
    assert aux_mask(names) == want


def test_fix_entropy_models_freezes_the_encoder_branch(rd):
    """With fix_entropy_models the encoder branch runs without a graph: a
    loss of the reconstruction reaches the decoder side only."""
    port = rd["port"]
    out, _, _ = port_rd(rd, fix_entropy_models=True)
    assert not out["quantized_code"]["y"].requires_grad
    out["fake_images"].square().mean().backward()
    enc = [p.grad for n, p in port.named_parameters() if n.startswith(
        ("encoder.", "hyperencoder.", "hyperdecoder.", "context_model.", "entropy_model_z."))]
    assert all(g is None for g in enc)
    assert any(p.grad is not None and p.grad.abs().sum() > 0
               for n, p in port.named_parameters() if n.startswith("fusion_module."))
