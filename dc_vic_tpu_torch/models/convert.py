"""Loading weights in the reference's torch layout.

The port's parameter names are the reference's state-dict keys, so a dict
in that layout (the JAX package's ``export_state_dict`` output, or a
released ``.pth.tar``'s ``comp_model`` entry as numpy arrays) loads as is.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def load_reference_state_dict(model: nn.Module, sd: Dict[str, np.ndarray]) -> None:
    """Load ``sd`` (numpy arrays keyed by reference torch names) strictly:
    raise on any missing or extra key or any shape that does not match.

    Dense layers are stored 2-D here; a 1x1-conv weight (O, I, 1, 1), as
    the reference stores its FiLM and quant convs, is accepted for them."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"state dict does not match the model: missing {missing}, "
                       f"unexpected {extra}")
    tensors = {}
    for key, value in sd.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        want = own[key].shape
        if t.shape != want and t.dim() == 4 and t.shape[2:] == (1, 1) \
                and t.shape[:2] == want:
            t = t[:, :, 0, 0]
        if t.shape != want:
            raise ValueError(f"shape mismatch for {key}: got {tuple(t.shape)}, "
                             f"model has {tuple(want)}")
        tensors[key] = t.to(own[key].dtype)
    model.load_state_dict(tensors, strict=True)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def balle18_hyperprior_state_dict(flax_params) -> Dict[str, np.ndarray]:
    """The JAX package's Balle18 hyperprior parameters -> the port's keys.

    Its flax children are anonymous (``hyperencoder/Conv_0..2`` and
    ``hyperdecoder/DeconvTorch_0..1, Conv_0``, each wrapping a ``Conv_0``),
    names the JAX package's own path map reads as the Minnen'20 towers' (a
    deconv would get the conv layout), so they are mapped here: the model's
    parameter tree (with or without its ``params`` level, leaves as numpy)
    -> ``hyperencoder.conv{1,2,3}`` and ``hyperdecoder.conv{1,2,3}`` (conv1
    and conv2 transposed convs). Only the Balle18 modules in the tree give
    keys."""
    tree = flax_params.get("params", flax_params)
    names = {"hyperencoder": {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3"},
             "hyperdecoder": {"DeconvTorch_0": "conv1", "DeconvTorch_1": "conv2",
                              "Conv_0": "conv3"}}
    out = {}
    for root, children in names.items():
        sub = tree.get(root, {})
        if not set(sub) <= set(children) or not sub:
            continue                                   # not a Balle18 module
        for child, name in children.items():
            leaves = sub[child]["Conv_0"]
            w = np.asarray(leaves["kernel"])           # HWIO
            if child.startswith("DeconvTorch"):        # a correlation over the dilated input
                w = np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1]
            else:
                w = np.transpose(w, (3, 2, 0, 1))
            out[f"{root}.{name}.weight"] = np.ascontiguousarray(w)
            out[f"{root}.{name}.bias"] = np.asarray(leaves["bias"])
    return out


def _disc_leaf(path, leaf):
    """One flax leaf of a discriminator -> (the port's parameter suffix, its
    array): convs HWIO -> OIHW, dense kernels transposed, norm scales ->
    weights, ActNorm's own ``scale`` and ``loc`` kept."""
    leaf = np.asarray(leaf)
    name = path[-1]
    if name == "kernel":
        leaf = np.transpose(leaf, (3, 2, 0, 1)) if leaf.ndim == 4 else leaf.T
    key = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "loc": "loc", "mean": "running_mean", "var": "running_var"}[name]
    if name == "scale" and len(path) >= 2 and path[-2].startswith("_Norm"):
        key = "scale"                                   # ActNorm's own parameters
    return key, np.ascontiguousarray(leaf)


def _norm_base(base: str, inner) -> str:
    """A ``_Norm``'s port name: a wrapped flax LayerNorm sits one level down."""
    return base + (".norm" if len(inner) > 2 and inner[1].startswith("LayerNorm") else "")


def _film_discriminator_state_dict(tree) -> Dict[str, np.ndarray]:
    """``DualBetaFtTamingNLayerDiscriminator``: ``DualBetaCondMLP_0``
    -> ``mlp``, ``Conv_i`` -> ``convs.i``, ``_Norm_i`` -> ``norms.i``,
    ``BetaScaleShift_i`` (``Dense_0`` shared, ``Dense_1`` scale, ``Dense_2``
    shift) -> ``films.i``."""
    film = {"Dense_0": "shared.0", "Dense_1": "scale", "Dense_2": "shift"}
    out = {}
    for path, leaf in _flatten(tree):
        kind, i = path[0].rsplit("_", 1)
        if kind == "DualBetaCondMLP":
            base = {"Dense_0": "mlp.0", "Dense_1": "mlp.2"}[path[1]]
        elif kind == "BetaScaleShift":
            base = f"films.{i}.{film[path[1]]}"
        elif kind == "Conv":
            base = f"convs.{i}"
        else:
            base = _norm_base(f"norms.{i}", path)
        key, arr = _disc_leaf(path, leaf)
        out[f"{base}.{key}"] = arr
    return out


def discriminator_state_dict(flax_params) -> Dict[str, np.ndarray]:
    """The JAX package's discriminator parameters (the nested dict of
    ``disc.init``, with or without its ``params`` level, leaves as numpy)
    -> the port's discriminator state dict (``models/discriminators.py``).
    Takes ``TamingNLayerDiscriminator`` (top-level convs),
    ``DualBetaCondTamingNLayerDiscriminator`` (``Dense_*``, ``trunk``, the
    y_hat branch's ``Conv_0``), ``OasisDualBetaCondTamingNLayerDiscriminator``
    (the latter under ``body``) and ``DualBetaFtTamingNLayerDiscriminator``."""
    from .discriminators import trunk_conv_position

    tree = flax_params.get("params", flax_params)
    if "body" in tree:
        return {f"body.{k}": v for k, v in discriminator_state_dict(tree["body"]).items()}
    if "DualBetaCondMLP_0" in tree:
        return _film_discriminator_state_dict(tree)
    dual = "trunk" in tree
    out = {}
    for path, leaf in _flatten(tree):
        if dual and path[0] != "trunk":
            base = {"Dense_0": "cond_mlp.0", "Dense_1": "cond_mlp.2",
                    "Conv_0": "y_hat_conv"}[path[0]]
        else:
            inner = path[1:] if dual else path
            kind, i = inner[0].rsplit("_", 1)
            pos = trunk_conv_position(int(i) + (1 if kind == "_Norm" else 0))
            base = ("trunk.main." if dual else "main.") + str(
                pos + (1 if kind == "_Norm" else 0))
            if kind == "_Norm":
                base = _norm_base(base, inner)
        key, arr = _disc_leaf(path, leaf)
        out[f"{base}.{key}"] = arr
    return out
