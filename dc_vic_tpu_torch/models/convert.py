"""Loading weights, and the Adam state that trains them, in the
reference's torch layout.

The port's parameter names are the reference's state-dict keys, so a dict
in that layout (the JAX package's ``export_state_dict`` output, or a
released ``.pth.tar``'s ``comp_model`` entry as numpy arrays) loads as is.
The flax trees that the JAX package's path map misnames (the Balle'18
hyperprior, the alternative ELIC transforms, the light SFT fusion, the
Balle'18 / Cheng'20 / Test transforms, GDN) are mapped here by flax path.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def _reference_tensors(shapes: Dict[str, tuple], sd: Dict[str, np.ndarray],
                       what: str = "state dict") -> Dict[str, torch.Tensor]:
    """``sd`` (numpy arrays keyed by reference torch names) as tensors of
    ``shapes``, strictly: raise on any missing or extra key or any shape
    that does not match. Dense layers are stored 2-D here; a 1x1-conv
    weight (O, I, 1, 1), as the reference stores its FiLM and quant convs,
    is accepted for them."""
    missing = sorted(set(shapes) - set(sd))
    extra = sorted(set(sd) - set(shapes))
    if missing or extra:
        raise KeyError(f"{what} does not match the model: missing {missing}, "
                       f"unexpected {extra}")
    tensors = {}
    for key, value in sd.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        want = torch.Size(shapes[key])
        if t.shape != want and t.dim() == 4 and t.shape[2:] == (1, 1) \
                and t.shape[:2] == want:
            t = t[:, :, 0, 0]
        if t.shape != want:
            raise ValueError(f"shape mismatch for {key}: got {tuple(t.shape)}, "
                             f"model has {tuple(want)}")
        tensors[key] = t
    return tensors


def load_reference_state_dict(model: nn.Module, sd: Dict[str, np.ndarray]) -> None:
    """Load ``sd`` (numpy arrays keyed by reference torch names) strictly,
    with the checks of ``_reference_tensors``."""
    own = model.state_dict()
    tensors = _reference_tensors({k: v.shape for k, v in own.items()}, sd)
    model.load_state_dict({k: t.to(own[k].dtype) for k, t in tensors.items()}, strict=True)


def load_reference_optimizer_state(opt, mu: Dict[str, np.ndarray], nu: Dict[str, np.ndarray],
                                   count, sched_count) -> None:
    """Fill ``opt`` (a ``train.optim.Optimizer``) with the reference
    trainer's Adam state: the first and second moments ``mu`` and ``nu``
    (numpy arrays keyed by reference torch names, as for the weights),
    Adam's own step count and the schedule's. The reference keeps moments
    for every weight and zeros for those its mask freezes; a key that this
    optimizer does not train must hold zeros, and every one it trains must
    be there, with the shape checks of ``load_reference_state_dict``."""
    shapes = {n: (opt.layout.shapes[n] if opt.layout is not None else tuple(p.shape))
              for n, p in zip(opt.names, opt.params)}
    state = {"count": torch.as_tensor(np.asarray(count), dtype=torch.int32),
             "sched_count": torch.as_tensor(np.asarray(sched_count), dtype=torch.int32)}
    for key, moments in (("mu", mu), ("nu", nu)):
        frozen = [k for k, v in moments.items() if k not in shapes and np.any(np.asarray(v))]
        if frozen:
            raise ValueError(f"optimizer state {key}: nonzero moments for {len(frozen)} "
                             f"weights this optimizer does not train, e.g. {frozen[0]}")
        state[key] = _reference_tensors(shapes, {k: v for k, v in moments.items()
                                                 if k in shapes}, f"optimizer state {key}")
    opt.load_state_dict(state)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# --------------------------------------------------------------------------
# The JAX package's flax trees of the ELIC transforms, the fusion blocks and
# the alternative transforms, mapped by flax path. Leaves come in as numpy
# (or anything ``np.asarray`` takes); convs HWIO -> OIHW, transposed convs
# (a correlation over the dilated input) -> (I, O, kH, kW) flipped, dense
# kernels transposed, GDN's ``gamma_raw`` transposed (see nn/layers.py::GDN).
# --------------------------------------------------------------------------

def _leaf_conv(out, base, leaves, deconv=False):
    w = np.asarray(leaves["kernel"])
    w = np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1] if deconv else np.transpose(w, (3, 2, 0, 1))
    out[f"{base}.weight"] = np.ascontiguousarray(w)
    out[f"{base}.bias"] = np.asarray(leaves["bias"])


def _conv(out, base, tree):
    """The JAX package's ``Conv`` (an ``nn.Conv`` named ``Conv_0`` inside)."""
    _leaf_conv(out, base, tree["Conv_0"])


def _deconv(out, base, tree):
    _leaf_conv(out, base, tree["Conv_0"], deconv=True)


def _pixel_shuffle(out, base, tree):
    """``PixelShuffleUp``: its ``Conv`` -> ``<base>.0`` (nn/layers.py::pixel_shuffle_up)."""
    _conv(out, f"{base}.0", tree["Conv_0"])


def _dense(out, base, leaves):
    out[f"{base}.weight"] = np.ascontiguousarray(np.asarray(leaves["kernel"]).T)
    out[f"{base}.bias"] = np.asarray(leaves["bias"])


def _gdn(out, base, tree):
    out[f"{base}.beta"] = np.asarray(tree["beta_raw"])
    out[f"{base}.gamma"] = np.ascontiguousarray(np.asarray(tree["gamma_raw"]).T)


def _bottleneck_blocks(out, base, tree):
    """``ResidualBottleneckBlocks``: ``BottleneckResBlock_i/Conv_{0,1,2}`` ->
    ``block{i}.conv.{0,2,4}``."""
    for child, sub in tree.items():
        i = int(child.rsplit("_", 1)[1])
        for j in range(3):
            _conv(out, f"{base}.block{i}.conv.{2 * j}", sub[f"Conv_{j}"])


def _nlam(out, base, tree):
    """``ChengNLAM``: ``NLAMResBlock_0..2`` trunk, ``_3..5`` attention,
    ``Conv_0`` the gate's 1x1."""
    for i in range(6):
        group = "trunk_block" if i < 3 else "attention_block"
        for j in range(3):
            _conv(out, f"{base}.{group}.{i % 3}.c{j + 1}", tree[f"NLAMResBlock_{i}"][f"Conv_{j}"])
    _conv(out, f"{base}.conv", tree["Conv_0"])


def _film(out, base, tree):
    """``BetaScaleShift``: ``Dense_0`` shared, ``Dense_1`` scale, ``Dense_2`` shift."""
    for child, name in (("Dense_0", "shared.0"), ("Dense_1", "scale"), ("Dense_2", "shift")):
        _dense(out, f"{base}.{name}", tree[child])


def elic_state_dict(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """An ELIC encoder's or decoder's flax tree (any of subnets.py's
    ELIC classes, with or without FiLM, VQ insertion or pixel shuffle;
    the decoders' ``layers`` wrapper included) -> the port's keys under
    ``prefix``. Named children keep their names; the decoders' anonymous
    up-convs ``DeconvTorch_i`` / ``PixelShuffleUp_i`` are ``conv{i+1}``,
    and the plain ElicDecoder's ``ResidualBottleneckBlocks_i`` and
    ``ChengNLAM_0`` are ``block{i+1}`` and ``attn2``."""
    pre = f"{prefix}." if prefix else ""
    out: Dict[str, np.ndarray] = {}
    for child, sub in tree.items():
        kind, _, idx = child.rpartition("_")
        if child == "layers":
            out.update(elic_state_dict(sub, prefix))
        elif child == "vq_ind_emb":
            out[f"{pre}vq_ind_emb.weight"] = np.asarray(sub)
        elif child == "beta_mlp":
            _dense(out, f"{pre}mlp.0", sub["Dense_0"])
            _dense(out, f"{pre}mlp.2", sub["Dense_1"])
        elif child == "init_fuse":
            _film(out, f"{pre}init_fuse", sub)
        elif kind == "beta_ft":
            _film(out, f"{pre}beta_ft_list.{idx}", sub)
        elif child in ("conv1", "conv2", "conv3", "conv4", "projection"):
            _conv(out, pre + child, sub)
        elif child.startswith("block"):
            _bottleneck_blocks(out, pre + child, sub)
        elif child.startswith("attn"):
            _nlam(out, pre + child, sub)
        elif kind == "DeconvTorch":
            _deconv(out, f"{pre}conv{int(idx) + 1}", sub)
        elif kind == "PixelShuffleUp":
            _pixel_shuffle(out, f"{pre}conv{int(idx) + 1}", sub)
        elif kind == "ResidualBottleneckBlocks":
            _bottleneck_blocks(out, f"{pre}block{int(idx) + 1}", sub)
        elif child == "ChengNLAM_0":
            _nlam(out, f"{pre}attn2", sub)
        else:
            raise KeyError(f"ELIC transform: no mapping for {child!r}")
    return out


def fusion_state_dict(tree) -> Dict[str, np.ndarray]:
    """The fusion blocks of a flax ``fused_decoder`` tree (its
    ``fusion_<key>`` children; the VQGAN layers are skipped) -> the port's
    ``fusion_module.fusion_modules.<key>`` keys. A light block
    (``Conv_0..3`` alone) is the 1x1 and 3x3 ``fuse_block``, then scale and
    shift; a full SFT block's ``GNResBlock_0`` is ``fuse_block`` and its
    ``Conv_0..3`` are scale.0, scale.2, shift.0, shift.2."""
    out: Dict[str, np.ndarray] = {}
    for child, sub in tree.items():
        if not child.startswith("fusion_"):
            continue
        base = f"fusion_module.fusion_modules.{child[len('fusion_'):]}"
        if "GNResBlock_0" in sub:
            res = sub["GNResBlock_0"]
            for norm, name in (("GroupNorm_0", "norm1"), ("GroupNorm_1", "norm2")):
                out[f"{base}.fuse_block.{name}.weight"] = np.asarray(res[norm]["scale"])
                out[f"{base}.fuse_block.{name}.bias"] = np.asarray(res[norm]["bias"])
            for j, name in enumerate(("conv1", "conv2", "conv_out")):
                if f"Conv_{j}" in res:
                    _conv(out, f"{base}.fuse_block.{name}", res[f"Conv_{j}"])
            names = ("scale.0", "scale.2", "shift.0", "shift.2")
        else:
            names = ("fuse_block.0", "fuse_block.2", "scale", "shift")
        for j, name in enumerate(names):
            _conv(out, f"{base}.{name}", sub[f"Conv_{j}"])
    return out


def transforms_state_dict(flax_params) -> Dict[str, np.ndarray]:
    """The parts of a DCVICModel parameter tree (with or without its
    ``params`` level) that the JAX package's path map cannot carry, mapped
    here: ``encoder`` and ``decoder`` (``elic_state_dict``) and the fusion
    blocks of ``fused_decoder`` (``fusion_state_dict``). The rest of the
    tree (VQGAN, hyperprior, context model, estimator, bottleneck) maps
    through that path map as before."""
    tree = flax_params.get("params", flax_params)
    out = elic_state_dict(tree["encoder"], "encoder")
    out.update(elic_state_dict(tree["decoder"], "decoder"))
    out.update(fusion_state_dict(tree.get("fused_decoder", {})))
    return out


def _cheng_res(out, base, tree):
    _conv(out, f"{base}.conv1", tree["Conv_0"])
    _conv(out, f"{base}.conv2", tree["Conv_1"])
    if "GDN_0" in tree:
        _gdn(out, f"{base}.actv2", tree["GDN_0"])
    if "Conv_2" in tree:
        _conv(out, f"{base}.skip", tree["Conv_2"])


def _cheng_up(out, base, tree):
    _pixel_shuffle(out, f"{base}.up", tree["PixelShuffleUp_0"])
    _conv(out, f"{base}.conv", tree["Conv_0"])
    if "GDN_0" in tree:
        _gdn(out, f"{base}.actv2", tree["GDN_0"])
    _pixel_shuffle(out, f"{base}.shortcut", tree["PixelShuffleUp_1"])


_SEQ_KINDS = {"Conv": _conv, "DeconvTorch": _deconv, "PixelShuffleUp": _pixel_shuffle,
              "GDN": _gdn, "ChengNLAM": _nlam, "ChengResBlock": _cheng_res,
              "ChengUpResBlock": _cheng_up}

# each alternative transform's flax children in call order, which is the
# order of its port's ``model`` Sequential; None marks a parameter-free
# layer (ReLU)
_SEQUENCES = {
    "Balle18Encoder": ["Conv_0", "GDN_0", "Conv_1", "GDN_1", "Conv_2", "GDN_2", "Conv_3"],
    "Balle18Decoder": ["DeconvTorch_0", "GDN_0", "DeconvTorch_1", "GDN_1", "DeconvTorch_2",
                       "GDN_2", "DeconvTorch_3"],
    "Cheng20Encoder": ["ChengResBlock_0", "ChengResBlock_1", "ChengResBlock_2", "ChengNLAM_0",
                       "ChengResBlock_3", "ChengResBlock_4", "ChengResBlock_5", "Conv_0",
                       "ChengNLAM_1"],
    "Cheng20Decoder": ["ChengNLAM_0", "ChengResBlock_0", "ChengUpResBlock_0", "ChengResBlock_1",
                       "ChengUpResBlock_1", "ChengNLAM_1", "ChengResBlock_2",
                       "ChengUpResBlock_2", "ChengResBlock_3", "PixelShuffleUp_0"],
    "TestEncoder": ["Conv_0", None, "Conv_1", None, "Conv_2", None, "Conv_3"],
    "TestDecoder": ["DeconvTorch_0", None, "DeconvTorch_1", None, "DeconvTorch_2", None,
                    "DeconvTorch_3"],
}


def transform_state_dict(type_name: str, flax_params) -> Dict[str, np.ndarray]:
    """A standalone transform's flax parameters (with or without the
    ``params`` level) -> the port's state dict of the registered class
    ``type_name``: the ELIC ones through ``elic_state_dict``, Balle'18,
    Cheng'20 and Test through their children in call order
    (models/alt_autoencoders.py). Raises KeyError on a child the transform
    does not have."""
    tree = flax_params.get("params", flax_params)
    if type_name.startswith("Elic"):
        return elic_state_dict(tree)
    seq = _SEQUENCES[type_name]
    if set(tree) != {c for c in seq if c}:
        raise KeyError(f"{type_name}: flax children {sorted(tree)}, expected "
                       f"{sorted(c for c in seq if c)}")
    out: Dict[str, np.ndarray] = {}
    for i, child in enumerate(seq):
        if child:
            _SEQ_KINDS[child.rpartition("_")[0]](out, f"model.{i}", tree[child])
    return out


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
            (_deconv if child.startswith("DeconvTorch") else _conv)(
                out, f"{root}.{name}", sub[child])
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
