"""The rest of the DCVICModel family against the JAX model on the same
weights: the four model types of ``tests/helpers.py::tiny_config`` (ChARM or
not, dual-beta or not), the Balle'18 hyperprior pair, and the stage 1_1
configuration's model at full width (built, not run).

Weights: seeded port weights plus noise, carried into flax
(``train_helpers.jax_params``) and back through ``export_state_dict`` ->
``load_reference_state_dict`` (strict). The flax side runs eagerly.
Floats agree within atol = rtol = 1e-3, the flagship parity tests'
tolerance; CDF indexes are equal except where the scale lies within 1e-4
relative of a table entry (under 0.1% of them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401
from helpers import tiny_config
from train_helpers import TOL, _nchw, _port_layout, flax_template, jax_params, recording

from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import export_state_dict
from dc_vic_tpu_torch.models import build_comp_model, init_weights
from dc_vic_tpu_torch.models.convert import (balle18_hyperprior_state_dict,
                                             load_reference_state_dict)

VARIANTS = [(True, True), (True, False), (False, True), (False, False)]
NAMES = {v: tiny_config(*v)["model"]["type"] for v in VARIANTS}
BETAS = (1.7, 2.6)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _indexes_ok(got, want, sigma):
    """CDF indexes equal but where the bounded scale lies within 1e-4
    relative of a table entry; those stay under 0.1%."""
    from dc_vic_tpu_torch.codec.gaussian import get_scale_table
    table = get_scale_table()[:-1].astype(np.float32)
    bad = got != want
    s = np.maximum(sigma, 0.11)
    near = np.min(np.abs(s[..., None] / table - 1), axis=-1) < 1e-4
    assert np.all(near[bad]) and bad.sum() <= 1e-3 * bad.size


def _port(cfg, params):
    port = build_comp_model(cfg, device="cpu").module.eval()
    load_reference_state_dict(port, export_state_dict(params))
    return port


@pytest.fixture(scope="module", params=VARIANTS, ids=lambda v: NAMES[v])
def pair(request):
    """(flax model, its params, the port with the same weights, config)."""
    cfg = tiny_config(*request.param)
    m = jax_build(cfg).module
    params = jax_params(m, cfg)
    return m, params, _port(cfg, params), cfg


def _betas(use_beta):
    if not use_beta:
        return (), ()
    return ((jnp.array([BETAS[0]]), jnp.array([BETAS[1]])),
            (torch.tensor([BETAS[0]]), torch.tensor([BETAS[1]])))


def test_model_flags_follow_the_type(pair):
    m, _, port, cfg = pair
    assert (port.use_charm, port.use_beta) == (m.use_charm, m.use_beta)
    assert port.num_slices == (6 if m.use_charm else 0)
    assert (port.context_model is None) == (not m.use_charm)
    assert port.bottleneck_y == m.bottleneck_y == 24


def test_eval_forward_matches_jax(pair):
    """The eval forward (hard rounds) of each model type: reconstruction,
    estimator outputs, latents, likelihoods and rates."""
    m, params, port, _ = pair
    x = np.random.default_rng(3).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jb, tb = _betas(m.use_beta)
    want = jax.tree.map(np.asarray, m.apply(params, jnp.asarray(x), *jb, is_train=False))
    with torch.no_grad():
        out = port(_nchw(x), *tb, is_train=False)
    for key in ("fake_images", "out_vq_logits", "out_vq_latent"):
        np.testing.assert_allclose(_nhwc(out[key]), want[key], **TOL, err_msg=key)
    np.testing.assert_array_equal(out["gt_vq_indices"].numpy(), want["gt_vq_indices"])
    for key in ("bpp", "qbpp", "bpp_per_sample", "vq_accuracy"):
        np.testing.assert_allclose(out[key].numpy(), want[key], **TOL, err_msg=key)
    for group in ("likelihoods", "q_likelihoods", "quantized_code", "latent_code"):
        for k in ("y", "z"):
            np.testing.assert_allclose(_nhwc(out[group][k]), want[group][k], **TOL,
                                       err_msg=f"{group}/{k}")


def test_estimate_entropy_matches_jax(pair, monkeypatch):
    """estimate_entropy alone on the same y, eval and training (the JAX
    draws recorded and replayed: z's, then y's, one per ChARM slice or one
    for all of y)."""
    from dc_vic_tpu_torch.codec.ops import Noise
    m, params, port, _ = pair
    y = np.random.default_rng(4).normal(0, 3, (2, 4, 4, 24)).astype(np.float32)
    want = m.apply(params, jnp.asarray(y), False, method=m.estimate_entropy)
    draws = []
    recording(monkeypatch, draws)
    train = m.apply(params, jnp.asarray(y), True, jax.random.PRNGKey(9),
                    method=m.estimate_entropy)
    monkeypatch.undo()
    assert len(draws) == 1 + (6 if m.use_charm else 1)
    with torch.no_grad():
        got = port.estimate_entropy(_nchw(y), False)
        got_train = port.estimate_entropy(_nchw(y), True, Noise(
            draws=[_port_layout(d) for d in draws]))
    for res, ref in ((got, want), (got_train, train)):
        ref = jax.tree.map(np.asarray, ref)
        for group in ("likelihoods", "q_likelihoods", "quantized_code"):
            for k in ("y", "z"):
                np.testing.assert_allclose(_nhwc(res[group][k]), ref[group][k], **TOL,
                                           err_msg=f"{group}/{k}")


def test_entropy_parameters_match_jax(pair):
    """The codec's chain entry: ChARM slice 0's (mu, indexes), or without
    ChARM y_means_indexes, y_symbolize and y_dequantize; and
    encode_deterministic's planes."""
    m, params, port, _ = pair
    img = np.random.default_rng(5).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    jb, tb = _betas(m.use_beta)
    jb = jb or (None, None)
    y, z_sym = m.apply(params, jnp.asarray(img), *jb, method=m.encode_front)
    ho, _ = m.apply(params, z_sym, method=m.hyper_decode)
    with torch.no_grad():
        t_ho, _ = port.hyper_decode(_nchw(np.asarray(z_sym)))
        np.testing.assert_allclose(_nhwc(t_ho), np.asarray(ho), **TOL)
        if m.use_charm:
            prev = jnp.zeros(y.shape[:3] + (0,), jnp.float32)
            mu, idx = m.apply(params, 0, ho, prev, method=m.charm_slice_params)
            t_mu, t_idx = port.charm_slice_params(0, _nchw(np.asarray(ho)), _nchw(prev))
            _, sigma = port.context_model.slice_params(0, _nchw(np.asarray(ho)), _nchw(prev))
        else:
            mu, idx = m.apply(params, ho, method=m.y_means_indexes)
            t_mu, t_idx = port.y_means_indexes(_nchw(np.asarray(ho)))
            sigma = _nchw(np.asarray(ho))[:, 24:]
            sym = m.apply(params, y, mu, method=m.y_symbolize)
            t_sym = port.y_symbolize(_nchw(np.asarray(y)), _nchw(np.asarray(mu)))
            assert t_sym.dtype == torch.int16
            diff = _nhwc(t_sym) != np.asarray(sym)
            pre = np.asarray(y) - np.asarray(mu)
            assert np.all(np.abs(np.abs(pre - np.floor(pre)) - 0.5)[diff] < 1e-4)
            y_hat = m.apply(params, sym, mu, method=m.y_dequantize)
            t_y_hat = port.y_dequantize(_nchw(np.asarray(sym)), _nchw(np.asarray(mu)))
            np.testing.assert_allclose(_nhwc(t_y_hat), np.asarray(y_hat), **TOL)
        np.testing.assert_allclose(_nhwc(t_mu), np.asarray(mu), **TOL)
        assert t_idx.dtype == torch.uint8
        _indexes_ok(_nhwc(t_idx), np.asarray(idx), _nhwc(sigma))
        want = m.apply(params, jnp.asarray(img), *jb, method=m.encode_deterministic)
        got = port.encode_deterministic(_nchw(img), *tb)
    for key in ("y_bits", "z_bits", "max_abs_y"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL,
                                   err_msg=key)
    assert (_nhwc(got["y_indexes"]) != np.asarray(want["y_indexes"])).mean() <= 1e-3
    assert (_nhwc(got["y_symbols"]) != np.asarray(want["y_symbols"])).mean() <= 1e-3


def test_reference_state_dict_loads_strictly(pair):
    """Each type's export_state_dict output loads with strict=True into the
    port's model of that type, and into no other type."""
    m, params, port, cfg = pair
    sd = export_state_dict(params)
    assert set(sd) == set(port.state_dict())
    fresh = build_comp_model(cfg, device="cpu").module
    load_reference_state_dict(fresh, sd)
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.ascontiguousarray(sd[k]), err_msg=k)
    for other in VARIANTS:
        if other != (m.use_charm, m.use_beta):
            with pytest.raises((KeyError, ValueError)):
                load_reference_state_dict(
                    build_comp_model(tiny_config(*other), device="cpu").module, sd)


def _balle18_config():
    cfg = tiny_config(False, False)
    cfg["subnet"]["hyperencoder"] = {"type": "Balle18HyperEncoder", "bottleneck_z": 16}
    cfg["subnet"]["hyperdecoder"] = {"type": "Balle18HyperDecoder", "hyper_out_ch": 48}
    return cfg


def test_balle18_hyperprior_pair_matches_jax():
    """Balle18HyperEncoder and Balle18HyperDecoder in a HyperpriorVicModel:
    the anonymous flax children map through
    ``balle18_hyperprior_state_dict`` (the JAX package's path map gives them
    the Minnen'20 names and a deconv the conv layout), the whole model loads
    strictly, and the pair and the eval forward match flax."""
    from dc_vic_tpu.models.convert import convert_state_dict
    cfg = _balle18_config()
    m = jax_build(cfg).module
    template = flax_template(m, cfg)
    seed = build_comp_model(cfg, device="cpu").module
    init_weights(seed, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in seed.state_dict().items()}
    params, report = convert_state_dict(sd, template)
    assert sorted(k for k in report["unused"]) == sorted(
        k for k in sd if k.startswith(("hyperencoder.", "hyperdecoder.")))
    # the Balle18 leaves from the port's seeded weights: OIHW -> HWIO; a
    # transposed conv's (I, O, kH, kW) flipped into the correlation layout
    tree = jax.tree.map(lambda a: a, params)
    names = {"hyperencoder": ("Conv_0", "Conv_1", "Conv_2"),
             "hyperdecoder": ("DeconvTorch_0", "DeconvTorch_1", "Conv_0")}
    for root, children in names.items():
        for i, child in enumerate(children):
            w, b = sd[f"{root}.conv{i + 1}.weight"], sd[f"{root}.conv{i + 1}.bias"]
            w = (np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1)) if child.startswith("Deconv")
                 else np.transpose(w, (2, 3, 1, 0)))
            tree["params"][root][child] = {"Conv_0": {"kernel": jnp.asarray(w),
                                                      "bias": jnp.asarray(b)}}
    mapped = balle18_hyperprior_state_dict(jax.tree.map(np.asarray, tree))
    assert sorted(mapped) == sorted(k for k in sd if k.startswith(("hyperencoder.",
                                                                    "hyperdecoder.")))
    for k, v in mapped.items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)
    full = {k: v for k, v in export_state_dict(tree).items()
            if not k.startswith(("hyperencoder.", "hyperdecoder."))}
    full.update(mapped)
    port = build_comp_model(cfg, device="cpu").module.eval()
    load_reference_state_dict(port, full)
    minnen = tiny_config()
    assert balle18_hyperprior_state_dict(flax_template(jax_build(minnen).module, minnen)) == {}

    rng = np.random.default_rng(6)
    y = rng.normal(0, 3, (2, 4, 4, 24)).astype(np.float32)
    z = m.apply(tree, jnp.asarray(y), method=lambda mod, y: mod.hyperencoder(y))
    ho = m.apply(tree, z, method=lambda mod, z: mod.hyperdecoder(z))
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(port.hyperencoder(_nchw(y))), np.asarray(z), **TOL)
        np.testing.assert_allclose(_nhwc(port.hyperdecoder(_nchw(np.asarray(z)))),
                                   np.asarray(ho), **TOL)
        x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
        want = m.apply(tree, jnp.asarray(x), is_train=False)
        out = port(_nchw(x), is_train=False)
    np.testing.assert_allclose(_nhwc(out["fake_images"]), np.asarray(want["fake_images"]),
                               **TOL)
    np.testing.assert_allclose(out["qbpp"].numpy(), np.asarray(want["qbpp"]), **TOL)


def test_stage1_1_config_builds_the_jax_model_s_parameters():
    """config/exp1_stage1_1.yaml at full width: the port builds on the CPU a
    HyperpriorCharmVicModel whose state dict has the keys and shapes the
    JAX model's parameters export to (shapes only: nothing runs at this
    width here); its factory records no betas."""
    import os
    from dc_vic_tpu.utils.config import load_config as jax_load_config
    from dc_vic_tpu_torch.utils.config import load_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "config", "exp1_stage1_1.yaml")
    spec = build_comp_model(load_config(path), device="cpu")
    port = spec.module
    assert (port.use_charm, port.use_beta, spec.max_beta_rate, spec.max_beta_vq) == (
        True, False, 0.0, 0.0)
    assert type(port.encoder).__name__ == "ElicVqCatScEncoder"
    assert type(port.decoder).__name__ == "ElicFeatFusionDecoder"
    jm = jax_build(jax_load_config(path)).module
    x0 = jnp.zeros((1, 64, 64, 3))
    template = jax.eval_shape(lambda r: jm.init({"params": r}, x0, is_train=False),
                              jax.random.PRNGKey(0))
    zero = np.zeros((), np.float32)
    shapes = {k: v.shape for k, v in export_state_dict(
        jax.tree.map(lambda t: np.broadcast_to(zero, t.shape), template)).items()}
    own = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert set(own) == set(shapes)
    mismatched = [k for k in own if own[k] != shapes[k] and not (
        len(shapes[k]) == 4 and shapes[k][2:] == (1, 1) and shapes[k][:2] == own[k])]
    assert not mismatched


def test_default_device_is_the_card():
    """build_comp_model without a device builds on cuda, and raises
    without one, for the new types as for the flagship."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    for v in VARIANTS[1:]:
        with pytest.raises(RuntimeError, match="CUDA"):
            build_comp_model(tiny_config(*v))
