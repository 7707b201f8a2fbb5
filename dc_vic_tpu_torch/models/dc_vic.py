"""The DC-VIC composite model (port of dc_vic_tpu/models/dc_vic.py).

The training forward (``forward``, ``estimate_entropy``, ``aux_loss``) and
the codec's methods live on one class. The codec drives the codec methods;
the encoder derives its entropy parameters through the same methods the
decoder calls (hyper_decode, charm_slice_params, charm_decode_step), so with
deterministic kernels both sides compute bitwise identical mu and CDF
indexes. Tensors are NCHW.

Numeric configuration. ``codec_dtype`` "bfloat16" puts the conv stacks whose
outputs never have to repeat between two runs of the chain (VQGAN encode,
analysis and synthesis transforms, hyperencoder, VQ estimator, fused VQGAN
decode) in bf16; the hyperdecoder and the context model stay f32, and every
tensor that crosses into entropy coding is widened to f32 exactly once (the
VQGAN latent before the quantizer, y before symbolisation and y_hat, z
before its symbols). ``entropy_precision`` "default" lets the
entropy-parameter convs multiply in one tensor-core pass (TF32 with f32
accumulation) instead of full f32: the counterpart of the JAX package's
single-pass products. It is scoped to the three entropy-chain methods, which
both sides call, and is a no-op on the CPU.
"""
from __future__ import annotations

import contextlib
import copy
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..codec.bottleneck import EntropyBottleneck
from ..codec.gaussian import GaussianConditional, get_scale_table
from ..codec.ops import Noise
from ..nn.layers import FuseSftBlock
from ..ops.layout import row_major as _row_major
from .vqgan import VQModel

GUMBEL_TAU = 1.0  # the Gumbel softmax temperature (the JAX package's default)
STRIDE = 64  # reflect-pad multiple of the image (4 stride-2 convs + 2 in the hyperprior)


def pad_image(x: torch.Tensor, stride: int = STRIDE) -> torch.Tensor:
    """Reflect-pad an NCHW image up to a stride multiple."""
    H, W = x.shape[2], x.shape[3]
    pad_h, pad_w = (-H) % stride, (-W) % stride
    if pad_h == 0 and pad_w == 0:
        return x
    return F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")


def crop_image(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return x[:, :, :H, :W]


def to_model_range(x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> [-1, 1] float32 (x/255, then (t - .5)/.5); float
    input passes through."""
    if x.dtype == torch.uint8:
        t = x.float() / 255.0
        return (t - 0.5) / 0.5
    return x


def likelihood_to_bpp(likelihood: torch.Tensor, num_pixel: int) -> torch.Tensor:
    """Bits of the likelihoods over ``num_pixel`` pixels."""
    return -torch.sum(torch.log(likelihood)) / math.log(2.0) / num_pixel


def likelihood_to_bpp_per_sample(likelihood: torch.Tensor,
                                 pixels_per_image: int) -> torch.Tensor:
    """Bits per pixel of each image [B] (the per-sample beta-weighted rate)."""
    return -torch.sum(torch.log(likelihood), dim=(1, 2, 3)) / math.log(2.0) / pixels_per_image


class FusionModule(nn.Module):
    """The SFT fusion blocks of the decoder, keyed by tap name."""

    def __init__(self, schedule: Dict[str, Dict[str, int]]):
        super().__init__()
        self.fusion_modules = nn.ModuleDict({
            key: FuseSftBlock(s["dec_ch"], s["cond_ch"], s["mid_ch"])
            for key, s in schedule.items()})


class EntropyChainMethods:
    """The entropy-parameter chain, written once for the two classes that
    run it: ``DCVICModel`` and ``EntropyChain``, its f32 copy on another
    device. Both sides of the codec call these methods, so with
    deterministic kernels they derive bitwise identical mu and CDF indexes.
    Reads ``hyperdecoder``, ``context_model``, ``entropy_model_z``,
    ``gaussian``, ``num_slices``, ``entropy_precision``, ``_scale_table``
    and ``_index_boundaries``."""

    @contextlib.contextmanager
    def _entropy_convs(self):
        """The products of the entropy-parameter convs: with
        ``entropy_precision`` "default" cuDNN may run them in TF32 inside
        this block (still deterministic algorithms); the process-wide
        setting is put back on the way out, also after an exception."""
        if (self.entropy_precision or "high") != "default":
            yield
            return
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = before

    def hyper_decode(self, z_symbols):
        """z symbols -> (hyper_out, z_hat)."""
        z_hat = self.entropy_model_z.dequantize(_row_major(z_symbols).to(torch.int32))
        with self._entropy_convs():
            return _row_major(self.hyperdecoder(z_hat)), z_hat

    def charm_symbolize(self, slice_ind: int, y, mu):
        """clip(round(y_i - mu)) of slice slice_ind, as int16."""
        sc = y.shape[1] // self.num_slices
        y_slice = y[:, slice_ind * sc:(slice_ind + 1) * sc]
        return _row_major(self.gaussian.quantize_symbols(y_slice, mu).to(torch.int16))

    def scale_boundaries(self, dev):
        """The scale table's boundaries on ``dev``, uploaded once per device
        (the codec does so when it is built), so that the decode chain never
        waits for a copy."""
        dev = torch.device(dev)
        if dev not in self._index_boundaries:
            self._index_boundaries[dev] = self.gaussian.index_boundaries(self._scale_table, dev)
        return self._index_boundaries[dev]

    def y_indexes(self, sigma):
        """CDF rows of the given scales."""
        return self.gaussian.build_indexes(sigma, self.scale_boundaries(sigma.device))

    def charm_slice_params(self, slice_ind: int, hyper_out, y_hat_prev):
        """(mu, CDF indexes uint8) of one slice."""
        with self._entropy_convs():
            mu, sigma = self.context_model.slice_params(
                slice_ind, _row_major(hyper_out), _row_major(y_hat_prev))
        return _row_major(mu), self.y_indexes(sigma).to(torch.uint8)

    def charm_decode_step(self, slice_ind: int, hyper_out, y_hat_prev, symbols, mu):
        """Reconstruct slice slice_ind from its symbols and predict (mu,
        indexes) of the next slice. Returns (y_hat_prev, mu_next, idx_next),
        the last two None after the final slice."""
        hyper_out, y_hat_prev = _row_major(hyper_out), _row_major(y_hat_prev)
        with self._entropy_convs():
            y_hat_slice = self.context_model.slice_reconstruct(
                slice_ind, hyper_out, y_hat_prev, _row_major(symbols).to(torch.int32),
                _row_major(mu))
        y_hat_prev = torch.cat([y_hat_prev, y_hat_slice], dim=1)
        if slice_ind + 1 >= self.num_slices:
            return y_hat_prev, None, None
        mu_next, idx_next = self.charm_slice_params(slice_ind + 1, hyper_out, y_hat_prev)
        return y_hat_prev, mu_next, idx_next


class DCVICModel(EntropyChainMethods, nn.Module):
    """HyperpriorCharmDualCondVicModel: dual-beta ELIC transforms, VQGAN
    prior, Minnen'20 hyperprior and ChARM context model."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 hyperencoder: nn.Module, hyperdecoder: nn.Module,
                 context_model: nn.Module, vq_estimator: nn.Module,
                 vq_model: VQModel, fusion_module: FusionModule,
                 entropy_model_z: EntropyBottleneck,
                 gaussian: GaussianConditional, n_embed: int = 256,
                 codec_dtype: Optional[str] = None,
                 entropy_precision: Optional[str] = "high",
                 gumbel_sampling: bool = False):
        super().__init__()
        self.codec_dtype = codec_dtype
        self.gumbel_sampling = gumbel_sampling
        self.entropy_precision = entropy_precision
        self.encoder = encoder
        self.decoder = decoder
        self.hyperencoder = hyperencoder
        self.hyperdecoder = hyperdecoder
        self.context_model = context_model
        self.vq_estimator = vq_estimator
        self.vq_model = vq_model
        self.fusion_module = fusion_module
        self.entropy_model_z = entropy_model_z
        self.gaussian = gaussian
        self.n_embed = n_embed
        self.num_slices = context_model.num_slices
        self._scale_table = get_scale_table()
        self._index_boundaries = {}   # device -> the scale table's boundaries there

    # ------------------------------------------------------------------ VQ
    def vq_encode(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frozen VQGAN encode + nearest-codeword quantize: (latent
        [B, D, h8, w8], indices [B, h8, w8])."""
        return self.vq_quantize(self.vq_model.encode(x).float())

    def vq_encode_tile(self, x_tile):
        """Pre-quant VQGAN latent of one tile batch, f32 [B, D, h8, w8]
        (split-encode path: the tiles' latents are stitched, then quantized
        once with ``vq_quantize``). Takes uint8 tiles or float in [-1, 1]."""
        return self.vq_model.encode(to_model_range(x_tile)).float()

    def vq_quantize(self, h) -> Tuple[torch.Tensor, torch.Tensor]:
        """Nearest-codeword quantize of a pre-quant latent: (latent,
        indices)."""
        return self.vq_model.quantize(h)

    def vq_indices_to_latent(self, indices):
        """Codebook lookup of a token map: indices [B, h8, w8] -> latents
        [B, D, h8, w8] (the rate search's precomputed-token path)."""
        return self.vq_model.quantize.lookup(indices)

    def comp_encode(self, x, gt_vq_latent, gt_vq_indices, beta_rate, beta_vq):
        onehot = F.one_hot(gt_vq_indices.long(), self.n_embed).permute(0, 3, 1, 2)
        feat = torch.cat([gt_vq_latent, onehot.to(gt_vq_latent.dtype)], dim=1)
        return self.encoder(x, feat, beta_rate, beta_vq).float()

    # ------------------------------------------------------- codec stages
    def encode_front(self, x, beta_rate, beta_vq):
        """Encode stage 1: image -> (y f32, z symbols int16). Everything after
        it is recomputed by the decoder through the methods below."""
        x = to_model_range(x)
        gt_vq_latent, gt_vq_indices = self.vq_encode(x)
        return self.encode_front_from_vq(x, gt_vq_latent, gt_vq_indices, beta_rate, beta_vq)

    def encode_front_from_vq(self, x, gt_vq_latent, gt_vq_indices, beta_rate, beta_vq):
        """encode_front with the VQ stage done already (the >1024 px split
        path)."""
        x = to_model_range(x)
        y = self.comp_encode(x, gt_vq_latent, gt_vq_indices, beta_rate, beta_vq)
        z = self.hyperencoder(y).float()
        z_sym = self.entropy_model_z.quantize_symbols(z)
        return y, z_sym.to(torch.int16)

    # -------------------------------------------------------------- decode
    def decode_from_y_hat(self, y_hat, beta_rate, beta_vq, w: float = 1.0,
                          noise: Optional[Noise] = None, use_gumbel: bool = False):
        """y_hat -> (image [-1, 1] f32, vq_latent_pred, vq_logits,
        vq_indices). y_hat comes in f32; the decoder's first conv casts it
        to the codec dtype. With ``use_gumbel`` and the model's
        ``gumbel_sampling``, the decoder reads the codebook mixed by a
        Gumbel softmax of the logits instead of the argmax codewords."""
        feat, cond_feats = self.decoder.get_feats(y_hat, beta_rate, beta_vq)
        pred_embed, logits = self.vq_estimator(feat)
        indices = torch.argmax(logits, dim=1)
        if use_gumbel and self.gumbel_sampling:
            g = noise.gumbel(logits.shape, logits)
            weights = torch.softmax((logits + g) / GUMBEL_TAU, dim=1)
            vq_latent = torch.einsum("bnhw,nd->bdhw", weights,
                                     self.vq_model.quantize.embedding.weight)
        else:
            vq_latent = self.vq_model.quantize.lookup(indices)
        vq_latent = self.vq_model.post_quant_conv(vq_latent)
        fake = self.vq_model.decoder(vq_latent, self.fusion_module.fusion_modules,
                                     cond_feats, w)
        return fake.float(), pred_embed, logits, indices

    def reconstruct_uint8(self, y_hat, beta_rate, beta_vq, w: float = 1.0):
        """y_hat -> uint8 image [B, 3, H, W]."""
        fake, *_ = self.decode_from_y_hat(y_hat, beta_rate, beta_vq, w)
        fake = torch.clamp(fake, -1.0, 1.0)
        return torch.round((fake + 1.0) * 127.5).to(torch.uint8)

    # ------------------------------------------------------------ training
    def estimate_entropy(self, y, is_train: bool, noise: Optional[Noise] = None) -> Dict:
        """y -> the quantized codes, the latents and the likelihoods of y and
        z, training (noise, straight-through rounds) or eval (hard rounds);
        ``q_likelihoods`` are those of the hard-rounded codes either way."""
        z = self.hyperencoder(y).float()
        z_hat, z_lik = self.entropy_model_z(z, is_train, noise)
        _, z_q_lik = self.entropy_model_z(z.detach(), False)
        with self._entropy_convs():
            hyper_out = self.hyperdecoder(z_hat)
            y_hat, y_lik, y_q_lik = self.context_model(
                y, hyper_out, is_train, noise, calc_q_likelihood=True)
        return dict(quantized_code=dict(y=y_hat, z=z_hat),
                    latent_code=dict(y=y, z=z),
                    likelihoods=dict(y=y_lik, z=z_lik),
                    q_likelihoods=dict(y=y_q_lik, z=z_q_lik))

    def forward(self, x, beta_rate, beta_vq, is_train: bool = True,
                noise: Optional[Noise] = None, fix_entropy_models: bool = False,
                w: float = 1.0) -> Dict:
        """The training (and eval) forward: x NCHW in [-1, 1], padded to a
        multiple of 64. The frozen VQGAN's encode carries no gradient; with
        ``fix_entropy_models`` neither does the encoder branch (the GAN
        stages). Noise draws, in order: z, the y slices, the Gumbel noise."""
        with torch.no_grad():
            gt_vq_latent, gt_vq_indices = self.vq_encode(x)

        def enc_branch():
            y = self.comp_encode(x, gt_vq_latent, gt_vq_indices, beta_rate, beta_vq)
            return y, self.estimate_entropy(y, is_train, noise)

        if fix_entropy_models:
            with torch.no_grad():
                y, entropy = enc_branch()
        else:
            y, entropy = enc_branch()
        fake, pred_embed, logits, indices = self.decode_from_y_hat(
            entropy["quantized_code"]["y"], beta_rate, beta_vq, w, noise,
            use_gumbel=is_train and self.gumbel_sampling)

        B, _, H, W = x.shape
        lik, q_lik = entropy["likelihoods"], entropy["q_likelihoods"]
        return dict(
            fake_images=fake,
            bpp_per_sample=(likelihood_to_bpp_per_sample(lik["y"], H * W)
                            + likelihood_to_bpp_per_sample(lik["z"], H * W)),
            out_vq_latent=pred_embed,
            gt_vq_latent=gt_vq_latent,
            out_vq_logits=logits,
            gt_vq_indices=gt_vq_indices,
            vq_accuracy=torch.mean((indices == gt_vq_indices).float()),
            bpp=(likelihood_to_bpp(lik["y"], B * H * W)
                 + likelihood_to_bpp(lik["z"], B * H * W)),
            qbpp=(likelihood_to_bpp(q_lik["y"], B * H * W)
                  + likelihood_to_bpp(q_lik["z"], B * H * W)),
            **entropy)

    @torch.no_grad()
    def extract_y_hat(self, x, beta_rate, beta_vq):
        """Encode-only eval y_hat, without reconstruction (the
        discriminator's y_hat condition for held-out real images)."""
        gt_vq_latent, gt_vq_indices = self.vq_encode(x)
        y = self.comp_encode(x, gt_vq_latent, gt_vq_indices, beta_rate, beta_vq)
        return self.estimate_entropy(y, is_train=False)["quantized_code"]["y"]

    @torch.no_grad()
    def encode_deterministic(self, x, beta_rate, beta_vq,
                             include_latents: bool = False) -> Dict:
        """Image (uint8, or float in [-1, 1]) -> symbol planes and per-image
        bit estimates in one pass: z and y symbols (int16), y CDF indexes
        (uint8), y symbol and index packed in one 16-bit word (index << 10
        | symbol + 512, as int16 bits), ``sym_plane`` (packed y then z per
        image, NCHW order), ``stats`` (y bits, z bits, max |y_hat|, max
        |symbol|). ``include_latents`` adds y_hat and z_hat."""
        x = to_model_range(x)
        gt_vq_latent, gt_vq_indices = self.vq_encode(x)
        y = self.comp_encode(x, gt_vq_latent, gt_vq_indices, beta_rate, beta_vq)
        z = self.hyperencoder(y).float()
        z_sym = self.entropy_model_z.quantize_symbols(z)
        z_hat = self.entropy_model_z.dequantize(z_sym)
        with self._entropy_convs():
            hyper_out = self.hyperdecoder(z_hat)
            y_sym, sigma, y_hat, y_lik = self.context_model.compress_forward(y, hyper_out)
        _, z_lik = self.entropy_model_z(z, False)
        y_idx = self.y_indexes(sigma)
        y_packed = ((y_idx << 10) | (torch.clamp(y_sym, -512, 511) + 512)).to(torch.int16)
        z_i16 = torch.clamp(z_sym, -32000, 32000).to(torch.int16)
        B = y.shape[0]
        y_bits = -torch.sum(torch.log(y_lik), dim=(1, 2, 3)) / math.log(2.0)
        z_bits = -torch.sum(torch.log(z_lik), dim=(1, 2, 3)) / math.log(2.0)
        max_abs_y = torch.max(torch.abs(y_hat))
        max_abs_sym = torch.max(torch.abs(y_sym)).float()
        out = dict(
            z_symbols=z_i16,
            y_symbols=torch.clamp(y_sym, -32000, 32000).to(torch.int16),
            y_indexes=y_idx.to(torch.uint8),
            y_packed=y_packed,
            sym_plane=torch.cat([y_packed.reshape(B, -1), z_i16.reshape(B, -1)], dim=1),
            stats=torch.cat([y_bits, z_bits, max_abs_y[None], max_abs_sym[None]]),
            y_bits=y_bits, z_bits=z_bits, max_abs_y=max_abs_y, max_abs_sym=max_abs_sym)
        if include_latents:
            out.update(y_hat=y_hat, z_hat=z_hat)
        return out

    def aux_loss(self) -> torch.Tensor:
        """The entropy bottleneck's quantile loss (the aux optimizer's)."""
        return self.entropy_model_z.aux_loss()


class EntropyChain(EntropyChainMethods, nn.Module):
    """f32 copies, on the CPU, of exactly the modules the entropy chain
    reads (hyperdecoder, context model, z bottleneck; the Gaussian model is
    parameter-free and shared). The codec's ``params_backend="cpu"`` runs
    the chain on this copy, so that a stream's entropy parameters come from
    the CPU on both sides whatever card encoded it. The model's own
    submodules, and with them its state-dict keys, stay where they are."""

    def __init__(self, model: DCVICModel):
        super().__init__()
        hyperdecoder, context_model, entropy_model_z = copy.deepcopy(
            (model.hyperdecoder, model.context_model, model.entropy_model_z))
        self.hyperdecoder = hyperdecoder.to(device="cpu", dtype=torch.float32).eval()
        self.context_model = context_model.to(device="cpu", dtype=torch.float32).eval()
        self.entropy_model_z = entropy_model_z.to(device="cpu", dtype=torch.float32).eval()
        self.gaussian = model.gaussian
        self.num_slices = model.num_slices
        self.entropy_precision = model.entropy_precision
        self._scale_table = model._scale_table
        self._index_boundaries = {}
