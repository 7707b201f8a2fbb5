"""Codec driver for the compressai stream format (port of the compressai
part of dc_vic_tpu/codec/driver.py::Codec).

compress: image -> encode_front on the device -> the entropy-parameter chain
(hyper_decode, charm_slice_params, then charm_symbolize and
charm_decode_step per slice) on the device -> host rANS coding. decompress
runs the same chain with symbols read back from the streams, so both sides
derive their CDF indexes from identical computations.

Scope: the compressai stream format, the reference's own byte format, with
a 6-byte header. Streams decode at the batch size they were encoded at, on
the same card class: the entropy parameters are floats, and a different
batch shape or device may pick different convolution algorithms (the tpu
stream format and portable mode are not ported).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.rans_host import RansDecoder, decode_with_indexes, encode_with_indexes
from .bottleneck import build_bottleneck_cdf
from .container import HeaderHandler
from .gaussian import get_scale_table

STRIDE = 64  # reflect-pad multiple of the image
Y_STRIDE = 16  # image pixels per y position


def _pad_np(x: np.ndarray, stride: int = STRIDE) -> np.ndarray:
    """Reflect-pad NHWC images to a stride multiple, keeping the dtype."""
    H, W = x.shape[1], x.shape[2]
    ph, pw = (-H) % stride, (-W) % stride
    if ph == 0 and pw == 0:
        return x
    return np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).cpu().numpy()


def _nchw_tensor(a: np.ndarray, device) -> torch.Tensor:
    """Decoded NHWC symbols -> NCHW int16 with row-major strides."""
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 3, 1, 2), dtype=np.int16)).to(device)


class Codec:
    """Compress and decompress with a built model (its device is the
    model's).

    Numerics: constructing a Codec sets, process-wide,
    ``torch.backends.cudnn.allow_tf32 = False``,
    ``torch.backends.cuda.matmul.allow_tf32 = False``,
    ``torch.backends.cudnn.deterministic = True`` and
    ``torch.backends.cudnn.benchmark = False``. cuDNN would otherwise run
    f32 convolutions in TF32 and may choose algorithms per call; a different
    algorithm between the encode and decode chains desynchronizes the
    stream. The whole codec runs in f32 under ``torch.no_grad``.

    Result dicts: ``string_list`` [header, z_str, y_str], ``num_pixel``,
    ``bpp`` (the container's actual bytes, length fields included), and
    with ``debug=True`` the encoder's ``y_hat``/``z_hat`` (NHWC numpy) for
    ``verify_roundtrip``. The JAX codec's ``pred_*_bpp`` estimates are not
    produced."""

    def __init__(self, spec):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        self.spec = spec
        self.module = spec.module.eval()
        self.device = next(self.module.parameters()).device
        self.num_slices = self.module.num_slices
        self.z_table = build_bottleneck_cdf(self.module.entropy_model_z)
        self.y_table = self.module.gaussian.build_cdf_table(get_scale_table())
        self._workers = min(16, os.cpu_count() or 1)

    def _betas(self, quality_ind: int):
        br, bv = self.spec.quality_betas(quality_ind)
        return (torch.tensor([br], dtype=torch.float32, device=self.device),
                torch.tensor([bv], dtype=torch.float32, device=self.device))

    # ------------------------------------------------------------ encode
    def _encode_param_chain(self, y, z_sym):
        """The decoder's own chain, driven with the encoder's symbols.
        Returns (per-slice symbols, per-slice indexes, y_hat, z_hat)."""
        m = self.module
        hyper_out, z_hat = m.hyper_decode(z_sym)
        B, _, yH, yW = y.shape
        y_prev = torch.zeros((B, 0, yH, yW), dtype=torch.float32, device=y.device)
        mu, idx = m.charm_slice_params(0, hyper_out, y_prev)
        syms, idxs = [], []
        for i in range(self.num_slices):
            sym = m.charm_symbolize(i, y, mu)
            syms.append(sym)
            idxs.append(idx)
            y_prev, mu, idx = m.charm_decode_step(i, hyper_out, y_prev, sym, mu)
        return syms, idxs, y_prev, z_hat

    @torch.no_grad()
    def compress(self, images: np.ndarray, quality_ind: int = 0,
                 debug: bool = False) -> List[Dict]:
        """images: [B, H, W, 3] uint8, or float in [-1, 1] (unpadded).
        Returns one result dict per image."""
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected [B, H, W, 3] images, got {images.shape}")
        B, H, W = images.shape[:3]
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
        x = torch.from_numpy(np.ascontiguousarray(_pad_np(images))).to(self.device)
        b1, b2 = self._betas(quality_ind)
        y, z_sym = self.module.encode_front(x.permute(0, 3, 1, 2), b1, b2)
        syms, idxs, y_hat, z_hat = self._encode_param_chain(y, z_sym)

        def slice_major(planes):  # per image: slice, then (h, w, c) order
            return torch.stack([p.permute(0, 2, 3, 1) for p in planes], dim=1) \
                .reshape(B, -1).to(torch.int32).cpu().numpy()
        y_sym, y_idx = slice_major(syms), slice_major(idxs)
        z_np = _nhwc(z_sym).astype(np.int32)
        z_idx = np.broadcast_to(np.arange(z_np.shape[-1], dtype=np.int32),
                                z_np.shape[1:]).reshape(-1)
        max_abs_y = float(torch.max(torch.abs(y_hat)))
        with ThreadPoolExecutor(self._workers) as pool:
            z_strs = list(pool.map(lambda b: encode_with_indexes(
                z_np[b].reshape(-1), z_idx, self.z_table), range(B)))
            y_strs = list(pool.map(lambda b: encode_with_indexes(
                y_sym[b], y_idx[b], self.y_table), range(B)))

        results = []
        y_hat_np = _nhwc(y_hat) if debug else None
        z_hat_np = _nhwc(z_hat) if debug else None
        for b in range(B):
            header = HeaderHandler.encode((H, W), max_abs_y, quality_ind)
            strings = [header, z_strs[b], y_strs[b]]
            r = dict(string_list=strings, num_pixel=H * W,
                     bpp=8.0 * sum(4 + len(s) for s in strings) / (H * W))
            if debug:
                r["y_hat"] = y_hat_np[b]
                r["z_hat"] = z_hat_np[b]
            results.append(r)
        return results

    # ------------------------------------------------------------ decode
    def _parse(self, string_lists) -> Tuple[int, int, int]:
        headers = [HeaderHandler.decode(s[0]) for s in string_lists]
        H, W = headers[0]["img_size"]
        q = headers[0]["quality_ind"]
        for h in headers:
            if h["stream_format"] != "compressai" or h["portable"]:
                raise ValueError("the port decodes non-portable compressai-format "
                                 "streams only")
            if h["img_size"] != (H, W) or h["quality_ind"] != q:
                raise ValueError("a decode batch must share image size and quality")
        return H, W, q

    def _decode_latents(self, z_strs, y_strs, H: int, W: int):
        """Entropy-decode z and the ChARM slices of y; returns (y_hat, z_hat)."""
        m = self.module
        B = len(z_strs)
        padH, padW = -(-H // STRIDE) * STRIDE, -(-W // STRIDE) * STRIDE
        zH, zW = padH // STRIDE, padW // STRIDE
        yH, yW = padH // Y_STRIDE, padW // Y_STRIDE
        Cz = m.entropy_model_z.channels
        z_idx = np.broadcast_to(np.arange(Cz, dtype=np.int32), (zH, zW, Cz)).reshape(-1)
        with ThreadPoolExecutor(self._workers) as pool:
            z_np = np.stack(list(pool.map(
                lambda s: decode_with_indexes(s, z_idx, self.z_table)
                .reshape(zH, zW, Cz), z_strs)))
            z_sym = _nchw_tensor(z_np, self.device)
            hyper_out, z_hat = m.hyper_decode(z_sym)

            decoders = [RansDecoder(s) for s in y_strs]
            y_prev = torch.zeros((B, 0, yH, yW), dtype=torch.float32, device=self.device)
            mu, idx = m.charm_slice_params(0, hyper_out, y_prev)
            for i in range(self.num_slices):
                idx_np = _nhwc(idx).astype(np.int32)
                sc = idx_np.shape[-1]
                sym = np.stack(list(pool.map(
                    lambda b: decoders[b].decode_stream(idx_np[b].reshape(-1), self.y_table)
                    .reshape(yH, yW, sc), range(B))))
                sym_t = _nchw_tensor(sym, self.device)
                y_prev, mu, idx = m.charm_decode_step(i, hyper_out, y_prev, sym_t, mu)
        return y_prev, z_hat

    @torch.no_grad()
    def decompress(self, string_lists: List[List[bytes]]) -> np.ndarray:
        """Decode same-size, same-quality streams, as one batch of the size
        they were encoded at. Returns images [B, H, W, 3] uint8."""
        H, W, q = self._parse(string_lists)
        y_hat, _ = self._decode_latents([s[1] for s in string_lists],
                                        [s[2] for s in string_lists], H, W)
        b1, b2 = self._betas(q)
        img = self.module.reconstruct_uint8(y_hat, b1, b2)
        return _nhwc(img[:, :, :H, :W])

    @torch.no_grad()
    def verify_roundtrip(self, results: List[Dict], string_lists: List[List[bytes]],
                         img_size: Tuple[int, int]) -> bool:
        """True when the decoder's y_hat and z_hat equal the encoder's
        bitwise. ``results`` come from ``compress(..., debug=True)``;
        ``img_size`` is the original (H, W)."""
        H, W, _ = self._parse(string_lists)
        if tuple(img_size) != (H, W):
            raise ValueError(f"img_size {img_size} != header size {(H, W)}")
        y_hat, z_hat = self._decode_latents([s[1] for s in string_lists],
                                            [s[2] for s in string_lists], H, W)
        y_hat, z_hat = _nhwc(y_hat), _nhwc(z_hat)
        return all(np.array_equal(y_hat[b], r["y_hat"])
                   and np.array_equal(z_hat[b], r["z_hat"])
                   for b, r in enumerate(results))
