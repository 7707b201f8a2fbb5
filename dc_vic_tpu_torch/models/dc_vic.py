"""The DC-VIC composite model, codec methods only (port of the eval and
codec-side methods of dc_vic_tpu/models/dc_vic.py).

The codec drives these methods; the encoder derives its entropy parameters
through the same methods the decoder calls (hyper_decode,
charm_slice_params, charm_decode_step), so with deterministic kernels both
sides compute bitwise identical mu and CDF indexes. Tensors are NCHW.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..codec.bottleneck import EntropyBottleneck
from ..codec.gaussian import GaussianConditional, get_scale_table
from ..nn.layers import FuseSftBlock
from .vqgan import VQModel

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


def _row_major(t: torch.Tensor) -> torch.Tensor:
    """t with the row-major strides of its shape. The strides pick the
    convolution kernel (a channels-last layout takes another kernel with
    another summation order), and a view such as a permuted [B, C, 1, 1]
    tensor counts as contiguous while it still reads as channels-last. The
    entropy chain passes its inputs through this, so the encoder and the
    decoder compute on the same layout whatever produced their tensors."""
    want, step = [], 1
    for n in reversed(t.shape):
        want.append(step)
        step *= n
    if tuple(reversed(want)) == t.stride():
        return t
    return t.clone(memory_format=torch.contiguous_format)


def to_model_range(x: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> [-1, 1] float32 (x/255, then (t - .5)/.5); float
    input passes through."""
    if x.dtype == torch.uint8:
        t = x.float() / 255.0
        return (t - 0.5) / 0.5
    return x


class FusionModule(nn.Module):
    """The SFT fusion blocks of the decoder, keyed by tap name."""

    def __init__(self, schedule: Dict[str, Dict[str, int]]):
        super().__init__()
        self.fusion_modules = nn.ModuleDict({
            key: FuseSftBlock(s["dec_ch"], s["cond_ch"], s["mid_ch"])
            for key, s in schedule.items()})


class DCVICModel(nn.Module):
    """HyperpriorCharmDualCondVicModel: dual-beta ELIC transforms, VQGAN
    prior, Minnen'20 hyperprior and ChARM context model."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module,
                 hyperencoder: nn.Module, hyperdecoder: nn.Module,
                 context_model: nn.Module, vq_estimator: nn.Module,
                 vq_model: VQModel, fusion_module: FusionModule,
                 entropy_model_z: EntropyBottleneck,
                 gaussian: GaussianConditional, n_embed: int = 256):
        super().__init__()
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

    # ------------------------------------------------------------------ VQ
    def vq_encode(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """Frozen VQGAN encode + nearest-codeword quantize: (latent
        [B, D, h8, w8], indices [B, h8, w8])."""
        h = self.vq_model.encode(x).float()
        return self.vq_model.quantize(h)

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
        y = self.comp_encode(x, gt_vq_latent, gt_vq_indices, beta_rate, beta_vq)
        z = self.hyperencoder(y).float()
        z_sym = self.entropy_model_z.quantize_symbols(z)
        return y, z_sym.to(torch.int16)

    def hyper_decode(self, z_symbols):
        """z symbols -> (hyper_out, z_hat)."""
        z_hat = self.entropy_model_z.dequantize(_row_major(z_symbols).to(torch.int32))
        return _row_major(self.hyperdecoder(z_hat)), z_hat

    def charm_symbolize(self, slice_ind: int, y, mu):
        """clip(round(y_i - mu)) of slice slice_ind, as int16."""
        sc = y.shape[1] // self.num_slices
        y_slice = y[:, slice_ind * sc:(slice_ind + 1) * sc]
        return _row_major(self.gaussian.quantize_symbols(y_slice, mu).to(torch.int16))

    def y_indexes(self, sigma):
        return self.gaussian.build_indexes(sigma, self._scale_table)

    def charm_slice_params(self, slice_ind: int, hyper_out, y_hat_prev):
        """(mu, CDF indexes uint8) of one slice."""
        mu, sigma = self.context_model.slice_params(
            slice_ind, _row_major(hyper_out), _row_major(y_hat_prev))
        return _row_major(mu), self.y_indexes(sigma).to(torch.uint8)

    def charm_decode_step(self, slice_ind: int, hyper_out, y_hat_prev, symbols, mu):
        """Reconstruct slice slice_ind from its symbols and predict (mu,
        indexes) of the next slice. Returns (y_hat_prev, mu_next, idx_next),
        the last two None after the final slice."""
        hyper_out, y_hat_prev = _row_major(hyper_out), _row_major(y_hat_prev)
        y_hat_slice = self.context_model.slice_reconstruct(
            slice_ind, hyper_out, y_hat_prev, _row_major(symbols).to(torch.int32),
            _row_major(mu))
        y_hat_prev = torch.cat([y_hat_prev, y_hat_slice], dim=1)
        if slice_ind + 1 >= self.num_slices:
            return y_hat_prev, None, None
        mu_next, idx_next = self.charm_slice_params(slice_ind + 1, hyper_out, y_hat_prev)
        return y_hat_prev, mu_next, idx_next

    # -------------------------------------------------------------- decode
    def decode_from_y_hat(self, y_hat, beta_rate, beta_vq, w: float = 1.0):
        """y_hat -> (image [-1, 1], vq_latent_pred, vq_logits, vq_indices)."""
        feat, cond_feats = self.decoder.get_feats(y_hat, beta_rate, beta_vq)
        pred_embed, logits = self.vq_estimator(feat)
        indices = torch.argmax(logits, dim=1)
        vq_latent = self.vq_model.post_quant_conv(self.vq_model.quantize.lookup(indices))
        fake = self.vq_model.decoder(vq_latent, self.fusion_module.fusion_modules,
                                     cond_feats, w)
        return fake.float(), pred_embed, logits, indices

    def reconstruct_uint8(self, y_hat, beta_rate, beta_vq, w: float = 1.0):
        """y_hat -> uint8 image [B, 3, H, W]."""
        fake, *_ = self.decode_from_y_hat(y_hat, beta_rate, beta_vq, w)
        fake = torch.clamp(fake, -1.0, 1.0)
        return torch.round((fake + 1.0) * 127.5).to(torch.uint8)
