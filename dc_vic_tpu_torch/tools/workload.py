"""The deployment workload: the one configuration and traffic the codec is
timed at, shared by ``chip_smoke.py`` and ``tools/recon_ab.py --deployment``.

bf16 conv stacks with ``entropy_precision: default``, tpu stream format,
device encode backend, 512 lanes, a batch of sixteen 768x512 images of smooth
content plus noise, and encoder weights scaled by 0.55 so that random
weights land at a rate a trained model would write.
"""
from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch

DEPLOYMENT = dict(batch=16, lanes=512, rate_scale=0.55, H=768, W=512)


def smooth_images(B: int, H: int, W: int) -> np.ndarray:
    """Smooth low-frequency content plus sensor-like noise, [B, H, W, 3]
    uint8 from ``numpy.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.linspace(0, 4, H), np.linspace(0, 4, W), indexing="ij")
    base = (np.stack([np.sin(yy + p) * np.cos(xx * 0.7 + p)
                      for p in (0.0, 1.3, 2.1)], axis=-1) + 1.0) * 110.0
    return np.clip(base[None] + rng.normal(0, 12, (B, H, W, 3)), 0, 255).astype(np.uint8)


def deployment_images() -> np.ndarray:
    """The workload's batch: ``smooth_images`` [16, 768, 512, 3], seed 0."""
    return smooth_images(DEPLOYMENT["batch"], DEPLOYMENT["H"], DEPLOYMENT["W"])


def deployment_config(opt):
    """A copy of the model configuration ``opt`` with the deployment
    numerics set."""
    opt = copy.deepcopy(opt)
    opt["codec_dtype"], opt["entropy_precision"] = "bfloat16", "default"
    return opt


def variant_a(opt):
    """Variant A of the model options, on a dual-beta ChARM configuration
    (config/dc_vic_patchgan.yaml at full width): the token map embedded
    into the encoder (``long_indices``, ElicDualBetaFtVqEmbCatEncoder with a
    32-wide embedding of the codebook's indices, projection after conv3),
    the VQGAN recon beside the image, the image in [0, 1], pixel-shuffle
    decoder upsampling, the light SFT fusion and a gelu estimator. Every
    key is one the JAX package's build_comp_model reads."""
    opt = copy.deepcopy(opt)
    sub = opt["subnet"]
    opt["model"]["enc_vq_input"] = "long_indices"
    opt["model"]["enc_input_vq_recon"] = True
    opt["convert_img_range_to_01"] = True
    sub["encoder"]["type"] = "ElicDualBetaFtVqEmbCatEncoder"
    sub["encoder"]["vq_n_embed"] = sub["vq_model"]["n_embed"]
    sub["encoder"]["vq_ind_embed_dim"] = 32
    sub["encoder"]["proj_pos"] = "conv3"
    sub["decoder"]["pixel_shuffle"] = True
    sub["fusion_module"]["fuse_type"] = "light_sft"
    sub["vq_estimator"]["act_type"] = "gelu"
    return opt


def variant_b(opt):
    """Variant B, on a single-beta ChARM configuration
    (config/exp1_stage1_1.yaml at full width): the normalized index beside
    the VQ latent (``norm_indices``, ElicVqScEncoder's 1x1 projection), a
    ``double_z`` VQGAN encoder and a leaky-ReLU estimator."""
    opt = copy.deepcopy(opt)
    sub = opt["subnet"]
    opt["model"]["enc_vq_input"] = "norm_indices"
    sub["encoder"]["type"] = "ElicVqScEncoder"
    sub["vq_model"]["ddconfig"]["double_z"] = True
    sub["vq_estimator"]["act_type"] = "leakyrelu"
    return opt


def scale_encoder(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of an f32 state dict with the encoder's parameters scaled by
    the workload's rate scale."""
    return {k: (v * DEPLOYMENT["rate_scale"] if k.startswith("encoder.") else v.clone())
            for k, v in state_dict.items()}


def _convs(prefix: str, convs, rng) -> Dict[str, np.ndarray]:
    """He-normal conv weights and small biases at ``{prefix}.{index}``;
    ``convs`` maps a Sequential index to (out, in, kernel)."""
    sd = {}
    for i, (cout, cin, k) in convs.items():
        sd[f"{prefix}.{i}.weight"] = (rng.standard_normal((cout, cin, k, k))
                                      * np.sqrt(2.0 / (cin * k * k))).astype(np.float32)
        sd[f"{prefix}.{i}.bias"] = (rng.standard_normal(cout) * 0.05).astype(np.float32)
    return sd


def metric_state_dicts(seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """Random weights of the evaluation networks, from
    ``numpy.random.default_rng(seed)``, under the keys their loaders read
    (the layouts of the released files): ``lpips_alex`` and ``lpips_vgg``
    (``net.features.{i}.*`` and ``lin{i}.model.1.weight``), ``dists``
    (``vgg16.features.{i}.*``, ``alpha``, ``beta`` of shape [1, 1475, 1,
    1]) and ``inception`` (torchvision's names, with the ``fc`` and
    ``AuxLogits`` keys the loaders skip). No pretrained weights are in the
    repository; these stand in for them wherever the networks are checked."""
    from ..metrics.feature_nets import AlexNetFeatures, VGG16Features
    from ..metrics.inception import InceptionV3Features
    rng = np.random.default_rng(seed)
    alex = {0: (64, 3, 11), 3: (192, 64, 5), 6: (384, 192, 3), 8: (256, 384, 3),
            10: (256, 256, 3)}
    vgg, cin = {}, 3
    for i, cout in zip(VGG16Features.CONVS,
                       (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)):
        vgg[i], cin = (cout, cin, 3), cout

    def heads(chans):
        return {f"lin{i}.model.1.weight": rng.uniform(0, 1, (1, c, 1, 1)).astype(np.float32)
                for i, c in enumerate(chans)}

    out = {"lpips_alex": {**_convs("net.features", alex, rng), **heads(AlexNetFeatures.CHANNELS)},
           "lpips_vgg": {**_convs("net.features", vgg, rng), **heads(VGG16Features.CHANNELS)}}
    n = 3 + sum(VGG16Features.CHANNELS)
    out["dists"] = {**_convs("vgg16.features", vgg, rng),
                    "alpha": rng.uniform(0, 1, (1, n, 1, 1)).astype(np.float32),
                    "beta": rng.uniform(0, 1, (1, n, 1, 1)).astype(np.float32)}
    inc = {}
    for name, t in InceptionV3Features().state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            inc[name] = np.zeros((), np.int64)
        elif name.endswith("conv.weight"):
            inc[name] = (rng.standard_normal(shape) * np.sqrt(2.0 / t[0].numel())
                         ).astype(np.float32)
        elif name.endswith(("running_var", "bn.weight")):
            inc[name] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            inc[name] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    inc["fc.weight"] = (rng.standard_normal((1008, 2048)) * 0.01).astype(np.float32)
    inc["fc.bias"] = np.zeros(1008, np.float32)
    inc["AuxLogits.conv0.conv.weight"] = np.zeros((128, 768, 1, 1), np.float32)
    out["inception"] = inc
    return out
