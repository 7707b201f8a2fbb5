"""The model options that the port once left out, each on its own in the
tiny configuration of ``tests/helpers.py::tiny_config``, against the JAX
model on the same weights (the encode or decode half the option changes,
floats within atol = rtol = 1e-3; the full forward of all of them at once is
tests/test_torch_alt_variants.py's), and one RD step of ``tools/workload.py::variant_a`` (all of A's options at once)
with its gradients against ``jax.value_and_grad``.

Weights as in tests/test_torch_alt_variants.py (``variant_helpers``: the
port's seeded init plus N(0, 0.02), carried by inverting the port's
converter). The RD step replays the JAX forward's noise draws
(``train_helpers.recording``) and holds every trained tensor's gradient
within a relative L2 error of 1e-3 (+1e-7), the zero-by-construction biases
below 1e-3 of their weight's gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from helpers import tiny_config
from train_helpers import TOL, _nchw, _port_layout, check_gradients, recording, zero_by_construction
from variant_helpers import VARIANTS, _nhwc, carried, model_state_dict

from dc_vic_tpu.train.losses import build_loss as jax_build_loss
from dc_vic_tpu.train.steps import BetaPolicy as JaxPolicy
from dc_vic_tpu.train.steps import _g_losses as jax_g_losses
from dc_vic_tpu_torch.codec.ops import Noise
from dc_vic_tpu_torch.train.losses import build_loss
from dc_vic_tpu_torch.train.optim import main_mask
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

# each option, and the half of the model it changes: the encode side
# (VQGAN encode, the encoder's input and VQ feature) or the decode side
# (ELIC synthesis, estimator, fusion)
FORMER_OPTIONS = {
    "enc_vq_input": ("encode", lambda c: c["model"].__setitem__("enc_vq_input",
                                                                "norm_indices")),
    "enc_input_vq_recon": ("encode", lambda c: c["model"].__setitem__("enc_input_vq_recon",
                                                                      True)),
    "fuse_type": ("decode", lambda c: c["subnet"]["fusion_module"].__setitem__("fuse_type",
                                                                               "concat")),
    "pixel_shuffle": ("decode", lambda c: c["subnet"]["decoder"].__setitem__("pixel_shuffle",
                                                                             True)),
    "estimator_act_type": ("decode", lambda c: c["subnet"]["vq_estimator"].__setitem__(
        "act_type", "gelu")),
    "double_z": ("encode", lambda c: c["subnet"]["vq_model"]["ddconfig"].__setitem__(
        "double_z", True)),
}


@pytest.mark.parametrize("option", sorted(FORMER_OPTIONS))
def test_former_unported_options_build_and_match_jax(option):
    """Each option that raised NotImplementedError until the port took it
    builds on the CPU, and the half of the model it changes matches the JAX
    model's: ``encode_front`` (y; z symbols but where z - median lies
    within 1e-4 of a rounding tie) or ``decode_from_y_hat`` (image,
    estimator logits and embedding, token map)."""
    side, set_option = FORMER_OPTIONS[option]
    cfg = tiny_config()
    set_option(cfg)
    jspec, params, spec = carried(cfg)
    m, port = jspec.module, spec.module
    rng = np.random.default_rng(5)
    jb, tb = (jnp.array([1.7]), jnp.array([2.6])), (torch.tensor([1.7]), torch.tensor([2.6]))
    if side == "encode":
        img = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
        y, z_sym = m.apply(params, jnp.asarray(img), *jb, method=m.encode_front)
        with torch.no_grad():
            ty, tz = port.encode_front(_nchw(img), *tb)
        np.testing.assert_allclose(_nhwc(ty), np.asarray(y), **TOL)
        assert (_nhwc(tz) != np.asarray(z_sym)).mean() <= 1e-3
        return
    y_hat = np.round(rng.normal(0, 3, (2, 4, 4, 24))).astype(np.float32)
    want = m.apply(params, jnp.asarray(y_hat), *jb, method=m.decode_from_y_hat)
    with torch.no_grad():
        got = port.decode_from_y_hat(_nchw(y_hat), *tb)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), **TOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_variant_a_rd_step_gradients_match_jax(monkeypatch):
    """One RD step of variant A (per-sample betas, the flagship stages'
    losses): loss terms within the model tests' tolerance and every trained
    tensor's gradient within 1e-3 relative L2, the index embedding, the
    light SFT blocks and the pixel-shuffle convs among them; the frozen
    VQGAN (the recon's decoder included) gets none."""
    cfg = VARIANTS["A"]()
    jspec, params, spec = carried(cfg)
    m = jspec.module
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    br, bv = np.array([2.4, 0.3], np.float32), np.array([1.1, 3.2], np.float32)
    jlosses = {k: jax_build_loss(v) for k, v in LOSSES.items()}
    policy = JaxPolicy(**POLICY)
    draws = []
    recording(monkeypatch, draws)

    def loss_fn(p, x, br, bv, key):
        del draws[:]
        out = m.apply(p, x, br, bv, is_train=True, rng=key)
        total, terms = jax_g_losses(m, jlosses, out, x, br, bv, policy)
        return total, (terms, list(draws))

    (total, (terms, got_draws)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, x, br, bv, jax.random.PRNGKey(5))
    monkeypatch.undo()
    port = spec.module.train()
    names = [n for n, _ in port.named_parameters()]
    train = main_mask(names)
    for n, p in port.named_parameters():
        p.requires_grad_(train[n])
    noise = Noise(draws=[_port_layout(d) for d in got_draws])
    ptotal, pterms, _ = rd_losses(port, {k: build_loss(v) for k, v in LOSSES.items()},
                                  _nchw(x), torch.from_numpy(br), torch.from_numpy(bv),
                                  BetaPolicy(**POLICY), noise)
    ptotal.backward()
    np.testing.assert_allclose(float(ptotal), float(total), **TOL)
    for k, v in terms.items():
        np.testing.assert_allclose(float(pterms[k]), float(v), **TOL, err_msg=k)
    for key in ("encoder.vq_ind_emb.weight", "decoder.conv1.0.weight",
                "fusion_module.fusion_modules.block_1_8.fuse_block.0.weight"):
        assert train[key], key
    assert not any(train[n] for n in names if n.startswith("vq_model."))
    want = model_state_dict(grads)
    checked = check_gradients(port, want, train, zero_by_construction(port))
    assert checked == sum(train.values())
