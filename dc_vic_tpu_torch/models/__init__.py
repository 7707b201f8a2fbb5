"""Model factory: reference-compatible YAML config -> torch model + codec
spec (port of dc_vic_tpu/models/__init__.py, flagship model family only)."""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional

import torch
from torch import nn

from ..codec.bottleneck import EntropyBottleneck
from ..codec.gaussian import GaussianConditional
from ..nn.layers import Conv2d, GroupNorm
from ..nn.swin import WindowAttention
from ..utils.registry import (CONTEXTMODEL_REGISTRY, DECODER_REGISTRY,
                              ENCODER_REGISTRY, HYPERDECODER_REGISTRY,
                              HYPERENCODER_REGISTRY, VQ_ESTIMATOR_REGISTRY)
from . import subnets  # noqa: F401  (registers the subnets)
from .dc_vic import DCVICModel, FusionModule
from .vqgan import VQModel, VQResnetBlock

_DROP = {"type"}

# build_comp_model's recon_kernels: each name switches on one family of
# reconstruction kernels, the JAX package's three opt-ins one for one.
RECON_KERNELS = ("gn", "conv3x3", "fused_resblock")


def _clean(cfg, drop=()) -> dict:
    out = dict(cfg or {})
    for k in set(drop) | _DROP:
        out.pop(k, None)
    return out


@dataclasses.dataclass
class CompModelSpec:
    """A built model plus the host-side codec metadata (quality-level beta
    tables; the largest beta_rate, the rate search's bound). The numeric configuration (``codec_dtype``,
    ``entropy_precision``) is carried by ``module``."""
    module: DCVICModel
    selected_beta_rate: Optional[List[float]] = None
    selected_beta_vq: Optional[List[float]] = None
    max_beta_rate: float = 3.0

    def quality_betas(self, quality_ind: int):
        if self.selected_beta_rate is None:
            raise ValueError("this model config selects no beta pairs")
        return (self.selected_beta_rate[quality_ind],
                self.selected_beta_vq[quality_ind])


def set_recon_kernels(module: nn.Module, recon_kernels: Iterable[str]) -> None:
    """Store the choice of reconstruction kernels on the modules it
    concerns: ``"gn"`` on every GroupNorm (kernels K3 and K4), ``"conv3x3"``
    on every ``nn.layers.Conv2d`` (K5; the entropy-parameter convs are plain
    ``nn.Conv2d`` and are never touched), ``"fused_resblock"`` on every
    VQResnetBlock (K6). Each module still applies its shape rule per call."""
    chosen = set(recon_kernels)
    unknown = chosen - set(RECON_KERNELS)
    if unknown:
        raise ValueError(f"recon_kernels {sorted(unknown)}: expected a subset of "
                         f"{RECON_KERNELS}")
    for m in module.modules():
        if isinstance(m, GroupNorm):
            m.recon_kernel = "gn" in chosen
        elif isinstance(m, Conv2d):
            m.recon_kernel = "conv3x3" in chosen
        elif isinstance(m, VQResnetBlock):
            m.fused = "fused_resblock" in chosen


# the stacks that compute in the codec dtype; the hyperdecoder, the context
# model and the entropy bottleneck stay f32 whatever it is
_CODEC_DTYPE_STACKS = ("encoder", "decoder", "hyperencoder", "vq_estimator", "vq_model",
                       "fusion_module")


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Round the conv and dense weights (and biases) under ``module`` to
    ``dtype``, once: each such layer then computes in that dtype. GroupNorm
    and LayerNorm parameters, the relative-position biases and the codebook
    stay f32, as their arithmetic does."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            m.to(dtype)


def build_comp_model(opt, device="cuda", recon_kernels: Iterable[str] = ()) -> CompModelSpec:
    """opt: full experiment config (opt.model and opt.subnet). Builds the
    model on ``device`` (the GPU unless the caller asks for another; without
    CUDA the default raises) with placeholder weights: call ``init_weights``
    or load a state dict before use. ``recon_kernels`` is a subset of
    ``RECON_KERNELS``; the empty default leaves every module on its ordinary
    PyTorch code. The config keys ``codec_dtype`` (null / "float32" /
    "bfloat16": the compute dtype of the conv stacks) and
    ``entropy_precision`` ("high" / "default": the products of the
    entropy-parameter convs) are validated here and carried by the module."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "build_comp_model: CUDA is not available; pass device='cpu' to "
            "build on the CPU")
    ep = opt.get("entropy_precision", "high")
    if ep not in (None, "high", "highest", "default"):
        raise ValueError(
            f"entropy_precision={ep!r}: expected 'high' (full f32, required for "
            "compressai-format parity streams), 'highest', or 'default' (single-pass "
            "tensor-core products in the entropy-parameter convs, scoped to the tpu "
            "stream format)")
    cd = opt.get("codec_dtype")
    if cd not in (None, "bfloat16", "float32"):
        raise ValueError(f"codec_dtype={cd!r}: expected 'bfloat16' or 'float32'/null")
    model_cfg = dict(opt["model"])
    if model_cfg.get("type") != "HyperpriorCharmDualCondVicModel":
        raise NotImplementedError(f"model type {model_cfg.get('type')!r} is not ported")
    if model_cfg.get("enc_vq_input", "onehot_indices") != "onehot_indices":
        raise NotImplementedError("only enc_vq_input=onehot_indices is ported")
    if model_cfg.get("enc_input_vq_recon", False) or opt.get("convert_img_range_to_01", False):
        raise NotImplementedError("enc_input_vq_recon / [0,1] image range are not ported")

    sub = opt["subnet"]
    enc, dec, vq = dict(sub["encoder"]), dict(sub["decoder"]), dict(sub["vq_model"])
    n_embed, embed_dim = vq.get("n_embed", 256), vq.get("embed_dim", 4)
    bottleneck_y = enc.get("out_ch", 192)
    bottleneck_z = dict(sub.get("entropy_model_z") or {}).get("channels", 192)
    feat_ch = embed_dim + n_embed  # one-hot indices ++ VQ latent
    if enc.get("input_feat_ch", feat_ch) != feat_ch:
        raise ValueError(f"encoder input_feat_ch {enc['input_feat_ch']} != {feat_ch}")

    enc_kw = _clean(enc, drop=("input_feat_ch", "proj_init", "proj_init_std"))
    dec_kw = _clean(dec, drop=("in_ch",))
    dec_kw["fusion_layer_dict"] = dict(dec_kw.get("fusion_layer_dict") or {})
    for kw in (enc_kw, dec_kw):
        for k in ("max_beta_1", "max_beta_2"):
            if kw.get(k, 0) is None:
                raise ValueError(f"{k} must be set for dual-cond models")
    ctx = _clean(sub.get("context_model"), drop=("bottleneck_y",))
    hyper_out_ch = dict(sub["hyperdecoder"]).get("hyper_out_ch", 256)
    ctx.setdefault("hyper_out_ch", hyper_out_ch)
    est = _clean(sub.get("vq_estimator"),
                 drop=("in_ch", "input_resolution", "n_embed", "embed_dim"))
    fusion = dict(sub.get("fusion_module") or {})
    if fusion.get("fuse_type", "sft") != "sft":
        raise NotImplementedError("only sft fusion is ported")
    sched = {k: {"dec_ch": v["dec_ch"], "cond_ch": v["cond_ch"],
                 "mid_ch": v.get("mid_ch", v["dec_ch"])}
             for k, v in dict(fusion.get("fuse_scedule_dict") or {}).items()}
    gaussian = GaussianConditional(
        scale_bound=dict(sub.get("entropy_model_y") or {}).get("scale_bound", 0.11))

    with torch.device(device):
        module = DCVICModel(
            encoder=ENCODER_REGISTRY.get(enc["type"])(input_feat_ch=feat_ch, **enc_kw),
            decoder=DECODER_REGISTRY.get(dec["type"])(in_ch=bottleneck_y, **dec_kw),
            hyperencoder=HYPERENCODER_REGISTRY.get(sub["hyperencoder"]["type"])(
                in_ch=bottleneck_y, **_clean(sub["hyperencoder"], drop=("bottleneck_y",))),
            hyperdecoder=HYPERDECODER_REGISTRY.get(sub["hyperdecoder"]["type"])(
                in_ch=bottleneck_z, **_clean(sub["hyperdecoder"], drop=("bottleneck_z",))),
            context_model=CONTEXTMODEL_REGISTRY.get(sub["context_model"]["type"])(
                bottleneck_y=bottleneck_y, gaussian=gaussian, **ctx),
            vq_estimator=VQ_ESTIMATOR_REGISTRY.get(sub["vq_estimator"]["type"])(
                in_ch=dec_kw.get("main_ch", 192), n_embed=n_embed,
                embed_dim=embed_dim, **est),
            vq_model=VQModel(n_embed, embed_dim, dict(vq.get("ddconfig") or {})),
            fusion_module=FusionModule(sched),
            entropy_model_z=EntropyBottleneck(bottleneck_z),
            gaussian=gaussian, n_embed=n_embed, codec_dtype=cd, entropy_precision=ep,
            gumbel_sampling=model_cfg.get("gumbel_sampling", False))
    module.to(device)  # buffers made from numpy start on the CPU
    if cd == "bfloat16":
        for name in _CODEC_DTYPE_STACKS:
            set_compute_dtype(getattr(module, name), torch.bfloat16)
    set_recon_kernels(module, recon_kernels)
    return CompModelSpec(
        module=module,
        selected_beta_rate=model_cfg.get("selected_beta_rate"),
        selected_beta_vq=model_cfg.get("selected_beta_vq"),
        max_beta_rate=enc_kw.get("max_beta_1", 3.0))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random initialisation following the JAX package's
    initialisers: lecun-normal conv/linear weights (truncated at two
    standard deviations), zero biases, unit norms, U(-1/n, 1/n) codebook,
    N(0, 0.02) relative-position biases and the entropy bottleneck's own
    scheme. The generator must live on the model's device. Weights held in
    bf16 are drawn in f32 and rounded, so a bf16 model gets the f32 model's
    weights of the same seed, rounded once."""
    def lecun(w, fan_in):
        std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
        draw = torch.empty_like(w, dtype=torch.float32)
        nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=generator)
        w.copy_(draw)

    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            lecun(m.weight, m.weight[0].numel())
        elif isinstance(m, nn.ConvTranspose2d):
            lecun(m.weight, m.weight.shape[0] * m.weight[0, 0].numel())
        elif isinstance(m, nn.Linear):
            lecun(m.weight, m.in_features)
        elif isinstance(m, nn.Embedding):
            n = m.num_embeddings
            nn.init.uniform_(m.weight, -1.0 / n, 1.0 / n, generator=generator)
        elif isinstance(m, (GroupNorm, nn.LayerNorm)):
            nn.init.ones_(m.weight)
        elif isinstance(m, WindowAttention):
            nn.init.trunc_normal_(m.relative_position_bias_table, 0.0, 0.02,
                                  -0.04, 0.04, generator=generator)
        elif isinstance(m, EntropyBottleneck):
            K = m.num_layers
            scale = 10.0 ** (1.0 / K)
            for i in range(K):
                mat = getattr(m, f"_matrix{i}")
                mat.fill_(math.log(math.expm1(1.0 / scale / mat.shape[1])))
                nn.init.uniform_(getattr(m, f"_bias{i}"), -0.5, 0.5, generator=generator)
                if i < K - 1:
                    getattr(m, f"_factor{i}").zero_()
            m.quantiles.copy_(torch.tensor([-10.0, 0.0, 10.0]).expand_as(m.quantiles))
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, GroupNorm,
                          nn.LayerNorm)) and m.bias is not None:
            nn.init.zeros_(m.bias)
