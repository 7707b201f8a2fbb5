"""What the codec cells share: the program's codec built from the
configuration with the benchmark's weights, the shapes each unit of work
has for the roofline and FLOP counts, and the judgement of sampled
outputs by the plain reference once the program is freed."""
from __future__ import annotations

import gc
from typing import Dict, List, Tuple

import torch

from . import harness, roofline, weights
from .reference import dcvic
from .reference.codec_judge import CodecReference, judge_batch


def shape_model(cfg: dict) -> dcvic.DCVIC:
    with torch.device("meta"):
        return dcvic.DCVIC(cfg["model_config"])


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    dep = cfg["deployment"]
    return weights.make_weights(shape_model(cfg), harness.torch_seed(seed, 1), device,
                                dep.get("rate_scale", 1.0), tuple(dep.get("bf16_stacks", ())))


def build_codec(cfg: dict, w: Dict[str, torch.Tensor], device):
    """The program's model with ``w`` and its ``Codec`` as the
    configuration deploys it."""
    from dc_vic_tpu_torch.codec.driver import Codec
    from dc_vic_tpu_torch.models import build_comp_model
    dep = cfg["deployment"]
    spec = build_comp_model(cfg["model_config"], device,
                            recon_kernels=tuple(dep.get("recon_kernels", ())))
    spec.module.load_state_dict(w)
    return Codec(spec, stream_format=dep["stream_format"], encode_backend=dep["encode_backend"],
                 lanes=dep["lanes"])


def release_memory() -> None:
    """Return the freed program's device memory before the reference runs
    (the caller drops its references first)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Tap:
    """What the program's encode front and its VQ estimator hand on, taken
    where they produce it, in the calls made while ``armed``: ``front``
    (VQGAN latent before the quantizer, y before the hyperencoder, z after
    it) and ``logits`` (the estimator's logits, whose argmax is the token
    map the VQGAN decoder takes). Forward hooks that keep references only,
    with no copy and no launch; disarmed they keep nothing, so only the
    units the check samples hold memory past their use."""

    def __init__(self, module):
        self.armed = False
        self.front, self.logits, self._h, self._y = None, None, None, None
        self._handles = [
            module.vq_model.quantize.register_forward_pre_hook(self._latent),
            module.hyperencoder.register_forward_pre_hook(self._analysis),
            module.hyperencoder.register_forward_hook(self._hyper),
            module.vq_estimator.register_forward_hook(self._estimator)]

    def _latent(self, mod, args):
        if self.armed:
            self._h = args[0]

    def _analysis(self, mod, args):
        if self.armed:
            self._y = args[0]

    def _hyper(self, mod, args, out):
        if self.armed:
            self.front = (self._h, self._y, out)

    def _estimator(self, mod, args, out):
        if self.armed:
            self.logits = out[1]

    def take(self):
        """(front, logits) of the armed calls since the last take; disarms."""
        got = (self.front, self.logits)
        self.armed, self.front, self.logits, self._h, self._y = False, None, None, None, None
        return got

    def close(self):
        for h in self._handles:
            h.remove()


def card_bytes(obj) -> int:
    """Bytes of the tensors in a nest of tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(card_bytes(o) for o in obj)
    return 0


def judge(cfg: dict, w, device, batches: List[Tuple], quant=None) -> Dict[str, float]:
    """The worst of each number over the sampled batches: (source images,
    quality, the program's string lists, its pixels, its front and its
    estimator's logits (``Tap``))."""
    ref = CodecReference(cfg["model_config"], w, device, quant)
    worst: Dict[str, float] = {}
    for images, q, strings, px, front, logits in batches:
        got = judge_batch(ref, images, q, strings, px, cfg["deployment"]["lanes"], front,
                          torch.argmax(logits, dim=1))
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def unit_counts(cfg: dict, B: int, H: int, W: int, encode: bool) -> Tuple[dict, float]:
    """(kernel calls, model FLOPs) of one unit: a round trip of a batch of
    B images (``encode``) or a decode of B images, counted on the
    reference's shapes on the meta device."""
    m = shape_model(cfg)
    mc = cfg["model_config"]
    zc = mc["subnet"]["entropy_model_z"]["channels"]
    pH, pW = -(-H // 64) * 64, -(-W // 64) * 64

    def run():
        b = torch.empty(B, device="meta")
        if encode:
            m.front(torch.empty(B, 3, pH, pW, device="meta"), b, b)
        zh = torch.empty(B, zc, pH // 64, pW // 64, device="meta")
        for _ in range(2 if encode else 1):
            ho = m.hyperdecoder(zh)
            prev = []
            for i in range(m.context_model.slices):
                mu, _, ms = m.context_model.mu_sigma(i, ho, prev)
                prev.append(m.context_model.lrp(i, ms, mu))
        m.decode_from_y_hat(torch.cat(prev, 1), b, b)

    esize = 2 if mc.get("codec_dtype") == "bfloat16" else 4
    calls = roofline.count_calls(m, run, cfg["deployment"].get("recon_kernels", ()), esize)
    return calls, roofline.flops_of(run)


def flop_peak(cfg: dict) -> float:
    return (roofline.BF16_PEAK if cfg["model_config"].get("codec_dtype") == "bfloat16"
            else roofline.TF32X3_PEAK)
