"""Weights for the parity tests of the alternative modules and model options
(tests/test_torch_alt_*.py): the port's seeded weights carried into a flax
tree by inverting the port's own converter, so that both sides hold the
same numbers and the converter is held to cover every flax element exactly
once.

The inversion runs the converter on a tree of element ids (each flax leaf
filled with consecutive integers): every converter transform is a
permutation (transposes and flips), so each port key's array of ids says
which flax elements its values go to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util
from helpers import tiny_config
from train_helpers import TOL, _nchw, flax_template

from dc_vic_tpu.models import build_comp_model as jax_build
from dc_vic_tpu.models.convert import export_state_dict
from dc_vic_tpu_torch.models import build_comp_model, init_weights
from dc_vic_tpu_torch.models.convert import load_reference_state_dict, transforms_state_dict
from dc_vic_tpu_torch.tools.workload import variant_a, variant_b

NOISE = 0.02    # added to the seeded weights, so that no bias is zero
VARIANTS = {"A": lambda: variant_a(tiny_config()),
            "B": lambda: variant_b(tiny_config(use_beta=False))}
BETAS = (1.7, 2.6)


def seeded_state_dict(module, seed=0, noise=NOISE):
    """``init_weights`` at ``seed`` plus N(0, noise), as numpy."""
    init_weights(module, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    return {k: v.float().numpy() + rng.normal(0, noise, v.shape).astype(np.float32)
            for k, v in module.state_dict().items()}


def carry(template, sd, to_port):
    """The flax tree of ``template``'s structure (shapes from its leaves)
    holding ``sd``'s values, where ``to_port(tree)`` maps a flax tree to the
    port's keys. Raises unless the keys are ``sd``'s and every flax element
    is written exactly once."""
    flat = traverse_util.flatten_dict(dict(template))
    ids, n = {}, 0
    for path, leaf in flat.items():
        size = int(np.prod(leaf.shape))
        ids[path] = np.arange(n, n + size, dtype=np.int64).reshape(leaf.shape)
        n += size
    mapped = to_port(traverse_util.unflatten_dict(ids))
    assert set(mapped) == set(sd), (sorted(set(mapped) ^ set(sd))[:8])
    buf = np.zeros(n, np.float32)
    hits = np.zeros(n, np.int64)
    for key, where in mapped.items():
        where = np.asarray(where)
        value = np.asarray(sd[key], np.float32)
        if where.shape != value.shape:      # a dense 1x1 exported as (O, I, 1, 1)
            value = value.reshape(where.shape)
        buf[where.ravel()] = value.ravel()
        np.add.at(hits, where.ravel(), 1)
    assert (hits == 1).all(), f"{int((hits != 1).sum())} flax elements not written once"
    return traverse_util.unflatten_dict({p: buf[i] for p, i in ids.items()})


def _without(tree, paths):
    flat = traverse_util.flatten_dict(dict(tree))
    return traverse_util.unflatten_dict(
        {p: v for p, v in flat.items() if not any(p[:len(q)] == q for q in paths)})


def _fusion_paths(tree):
    return [("fused_decoder", k) for k in tree.get("fused_decoder", {}) if k.startswith("fusion_")]


def model_state_dict(params):
    """A DCVICModel tree -> the port's state dict: the encoder, the decoder
    and the fusion blocks through the port's ``transforms_state_dict``, the
    rest through the JAX package's path map (a separate ``vq_model/decoder``,
    a copy of ``fused_decoder``'s VQGAN layers, is left out: both map to
    ``vq_model.decoder``)."""
    tree = params.get("params", params)
    rest = _without(tree, [("encoder",), ("decoder",), ("vq_model", "decoder")]
                    + _fusion_paths(tree))
    out = export_state_dict({"params": rest})
    out.update(transforms_state_dict(tree))
    return out


def model_params(template, sd):
    """``sd`` carried into the DCVICModel flax tree of ``template``; a
    ``vq_model/decoder`` (``enc_input_vq_recon``) gets ``fused_decoder``'s
    VQGAN leaves, as the reference loads both from one checkpoint."""
    tree = template.get("params", template)
    recon = "decoder" in tree.get("vq_model", {})
    carried = carry(_without(tree, [("vq_model", "decoder")]) if recon else tree, sd,
                    model_state_dict)
    if recon:
        carried["vq_model"]["decoder"] = {k: v for k, v in carried["fused_decoder"].items()
                                          if not k.startswith("fusion_")}
    return {"params": carried}


def carried(cfg):
    """(JAX spec, flax params, port spec) on the same weights."""
    jspec = jax_build(cfg)
    spec = build_comp_model(cfg, device="cpu")
    params = model_params(flax_template(jspec.module, cfg), seeded_state_dict(spec.module))
    load_reference_state_dict(spec.module, model_state_dict(params))
    spec.module.eval()
    return jspec, params, spec


def check_eval_forward(m, params, port, seed=3):
    """The eval forward of both packages on one batch: reconstruction,
    estimator outputs, token map, latents, likelihoods and rates."""
    x = np.random.default_rng(seed).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jb = (jnp.array([BETAS[0]]), jnp.array([BETAS[1]])) if m.use_beta else ()
    tb = (torch.tensor([BETAS[0]]), torch.tensor([BETAS[1]])) if m.use_beta else ()
    forward = jax.jit(lambda p, x, *b: m.apply(p, x, *b, is_train=False))
    want = jax.tree.map(np.asarray, forward(params, jnp.asarray(x), *jb))
    with torch.no_grad():
        out = port(_nchw(x), *tb, is_train=False)
    for key in ("fake_images", "out_vq_logits", "out_vq_latent"):
        np.testing.assert_allclose(_nhwc(out[key]), want[key], **TOL, err_msg=key)
    np.testing.assert_array_equal(out["gt_vq_indices"].numpy(), want["gt_vq_indices"])
    for key in ("bpp", "qbpp", "vq_accuracy"):
        np.testing.assert_allclose(out[key].numpy(), want[key], **TOL, err_msg=key)
    for group in ("likelihoods", "quantized_code", "latent_code"):
        for k in ("y", "z"):
            np.testing.assert_allclose(_nhwc(out[group][k]), want[group][k], **TOL,
                                       err_msg=f"{group}/{k}")


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()
