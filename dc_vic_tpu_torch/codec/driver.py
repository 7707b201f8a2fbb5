"""Codec driver: compress / decompress orchestration (port of
dc_vic_tpu/codec/driver.py::Codec, single device).

compress: image -> encode_front on the device -> the entropy-parameter chain
(hyper_decode, charm_slice_params, then charm_symbolize and
charm_decode_step per slice; without ChARM y_means_indexes, y_symbolize and
y_dequantize over the whole of y) on the device -> entropy coding.
decompress runs the same chain with symbols read back from the streams, so
both sides derive their CDF indexes from identical computations. A model
without beta conditioning ignores the betas; the header records the
quality all the same.

Two stream formats; decode detects the format from the header, so one Codec
reads both:

* "tpu" (default): the interleaved 32-bit rANS format of
  ``ops/rans_device.py``. Decode runs wholly on the device: z decode ->
  hyper_decode -> per slice (section decode -> charm_decode_step) ->
  reconstruction are queued on one stream (a y stream has one section per
  ChARM slice, or one section without ChARM), cursors and lane states stay on
  the device, and the image comes back with the consumed-word counts in one
  fetch: no host synchronisation inside the chain. Encode is on the device
  too with ``encode_backend="device"`` (symbols never leave it), or through
  the host coder with ``"host"``; both write the same bytes. Costs 4 bytes
  per lane per stream in rate. The 9-byte header records lanes, the encode
  batch, the numeric configuration and the escape guarantees, and the
  decoder fails fast on a mismatch.
* "compressai": the reference's own byte format with a 6-byte header; host
  entropy coding, one host round trip per ChARM slice on decode.

A tpu-format stream decodes on the card class that encoded it: the entropy
parameters are floats, and another device may round them otherwise. The
compressai format derives them on the CPU by default (``params_backend``
"cpu", the reference's placement): both sides run an f32 copy of the chain's
modules there, so a stream encoded on the card decodes bit-exactly on a
model built on the same host's CPU, at another thread count. Decoding on
another CPU class is not measured.
By default a stream also decodes only at the batch size it was encoded at,
because another batch shape may pick other convolution algorithms (the tpu
format's header makes a mismatch an error). ``portable=True`` lifts the batch coupling: every float
that gates symbol interpretation (hyper_out, per-slice mu, y_hat_prev) is
derived per image at the batch-1 shape on both sides, each operand in fresh
row-major storage of its own, and only integers (symbol planes, CDF indexes)
and the encoder-only y cross between the per-image chain and the batched
stages (front, device pack, section decodes, reconstruction). A portable
stream decodes bit-exactly alone or in any grouping, at the price of B times
the launches of the parameter chain. The header's portable bit chooses the
decode path, so any Codec reads both kinds.

Images whose larger side exceeds ``tiling.SPLIT_RESOLUTION`` (1024 px) are
tiled as the reference tiles them: the VQGAN encode runs on 512 px tiles at
stride 256 whose latents are stitched and quantized once, and the
reconstruction on 32 x 32 y cells at stride 16, stitched into the image.
Both run on the device in chunks of ``_TILE_CHUNK`` tiles, which bounds the
VQGAN attention's length and the memory whatever the image's size.

Several devices: ``Codec(spec, ..., mesh=devices)`` builds a
``codec.mesh.MeshCodec``, a composite of one single-device Codec per device
(that module's docstring).
"""
from __future__ import annotations

import functools
import itertools
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.dc_vic import EntropyChain
from ..ops import rans_device as rd
from ..ops.layout import row_major
from ..ops.rans_host import (RansDecoder, decode_with_indexes, encode_with_indexes,
                             tpu_encode_sections)
from .bottleneck import build_bottleneck_cdf
from .container import HeaderHandler
from .gaussian import get_scale_table
from ..utils.backends import backend_flags
from ..utils.profiling import count, span
from .tiling import (DEC_STRIDE_Y, DEC_WINDOW_Y, ENC_STRIDE, ENC_WINDOW, SPLIT_RESOLUTION,
                     keep_region, tile_starts)

STRIDE = 64  # reflect-pad multiple of the image
Y_STRIDE = 16  # image pixels per y position
VQ_STRIDE = 8  # image pixels per VQGAN latent position


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` copied to the host, which waits for the device's work on it:
    counted (``host_waits``, while a profiler records) at every such copy of
    the codec, on the CPU too."""
    count("host_waits")
    return t.cpu().numpy()


class PendingImages:
    """A decoded batch still on the device: one flat uint8 buffer holding
    the NHWC pixels followed by the consumed-word counts. ``fetch`` copies it
    to the host once, runs the stream-integrity check on the counts, and
    crops the images. ``seq``: the decode request's sequence number, in the
    ``codec.fetch`` span's args."""

    def __init__(self, data: torch.Tensor, meta: Tuple[int, int, int, int, int], check,
                 seq: Optional[int] = None):
        self._data = data
        self._meta = meta      # (B, padH, padW, H, W)
        self._check = check    # called with the [2, B] consumed-word counts
        self._seq = seq

    def fetch(self) -> np.ndarray:
        with span("codec.fetch", {"seq": self._seq}):
            B, padH, padW, H, W = self._meta
            host = _host(self._data)
            n = B * padH * padW * 3
            self._check(host[n:].view(np.int32).reshape(2, B))
            return host[:n].reshape(B, padH, padW, 3)[:, :H, :W]


def _pad_np(x: np.ndarray, stride: int = STRIDE) -> np.ndarray:
    """Reflect-pad NHWC images to a stride multiple, keeping the dtype."""
    H, W = x.shape[1], x.shape[2]
    ph, pw = (-H) % stride, (-W) % stride
    if ph == 0 and pw == 0:
        return x
    return np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return _host(t.permute(0, 2, 3, 1))


def _nchw_tensor(a: np.ndarray, device) -> torch.Tensor:
    """Decoded NHWC symbols -> NCHW int16 with row-major strides."""
    return torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 3, 1, 2), dtype=np.int16)).to(device)


def _split(t: torch.Tensor, per_image: bool) -> List[torch.Tensor]:
    """The operands of one run of the entropy-parameter chain: the batch as
    it is, or (portable streams) each image alone. A slice of the batch
    would be a view at a storage offset, and alignment is one of the things
    a convolution algorithm is chosen by; a clone is what a batch-1 decoder
    would hold."""
    if not per_image:
        return [t]
    return [t[b:b + 1].clone(memory_format=torch.contiguous_format)
            for b in range(t.shape[0])]


def _join(parts: List[torch.Tensor]) -> torch.Tensor:
    """Back to one batch: pure data movement, exact for floats too."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


class _ParamChain:
    """The entropy-parameter chain both sides run on the z symbols:
    hyper_decode, the first section's parameters, then one step per section
    of y: a ChARM slice (charm_decode_step), or without ChARM the whole of y
    (y_means_indexes, then y_dequantize). It runs over the whole batch, or
    with ``per_image`` (portable streams) once per image at the batch-1
    shape; either way the caller sees batch planes: ``indexes()`` of the
    section to come, ``step`` with that section's symbols, ``y_hat()`` and
    ``z_hat()`` at the end. Nothing here waits for the device. ``chain``:
    the model, or its ``EntropyChain`` copy on the CPU; it runs where its
    operands lie."""

    def __init__(self, chain, z_sym: torch.Tensor, y_plane: Tuple[int, int],
                 per_image: bool):
        self.m, self.per_image = chain, per_image
        self.charm = chain.num_slices > 0
        self.hyper = [chain.hyper_decode(z) for z in _split(z_sym, per_image)]
        n = z_sym.shape[0] // len(self.hyper)
        self.prevs = [torch.zeros((n, 0) + tuple(y_plane), dtype=torch.float32,
                                  device=z_sym.device) for _ in self.hyper]
        self.params = [chain.charm_slice_params(0, ho, prev) if self.charm
                       else chain.y_means_indexes(ho)
                       for (ho, _), prev in zip(self.hyper, self.prevs)]

    def indexes(self) -> torch.Tensor:
        return _join([idx for _, idx in self.params])

    def symbolize(self, i: int, ys: List[torch.Tensor]) -> torch.Tensor:
        """Encode side: section i's symbols of y (split as the chain is)."""
        return _join([self.m.charm_symbolize(i, y, mu) if self.charm
                      else self.m.y_symbolize(y, mu)
                      for y, (mu, _) in zip(ys, self.params)])

    def step(self, i: int, sym: torch.Tensor) -> None:
        parts = _split(sym, self.per_image)
        if not self.charm:
            self.prevs = [self.m.y_dequantize(part, mu)
                          for part, (mu, _) in zip(parts, self.params)]
            self.params = [(None, None)] * len(parts)
            return
        steps = [self.m.charm_decode_step(i, ho, prev, part, mu)
                 for (ho, _), prev, part, (mu, _) in zip(
                     self.hyper, self.prevs, parts, self.params)]
        self.prevs = [s[0] for s in steps]
        self.params = [s[1:] for s in steps]

    def y_hat(self) -> torch.Tensor:
        return _join(self.prevs)

    def z_hat(self) -> torch.Tensor:
        return _join([z_hat for _, z_hat in self.hyper])


def _tiled(H: int, W: int) -> bool:
    """The split paths' rule: the image's larger side exceeds
    SPLIT_RESOLUTION. Padded or not, the answer is the same, because 1024 is
    a multiple of the pad stride."""
    return max(H, W) > SPLIT_RESOLUTION


def _geometry(H: int, W: int):
    """(padH, padW, zH, zW, yH, yW) of an H x W image."""
    padH, padW = -(-H // STRIDE) * STRIDE, -(-W // STRIDE) * STRIDE
    return (padH, padW, padH // STRIDE, padW // STRIDE,
            padH // Y_STRIDE, padW // Y_STRIDE)


def _codec_call(method):
    """Run a Codec method under ``torch.no_grad`` with the codec's backend
    numerics (class docstring), restored on return."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        with torch.no_grad(), backend_flags(allow_tf32=False, deterministic=True,
                                            benchmark=False):
            return method(self, *args, **kwargs)
    return call


class Codec:
    """Compress and decompress with a built model (its device is the
    model's).

    ``stream_format``: "tpu" (default) or "compressai", the format
    ``compress`` writes. ``encode_backend``: "host" (default) or "device",
    where tpu-format streams are entropy-coded. ``lanes``: cap on the
    interleaved lanes of a tpu-format stream, a power of two in [1, 4096];
    more lanes mean fewer sequential steps per section and 4 bytes each per
    stream. It travels in the header. ``portable``: write streams that
    decode in any batch grouping (module docstring); decode follows each
    stream's header whatever this is. ``params_backend``: where the entropy
    parameters are derived, "cpu" or "accel" (the model's device); None
    means "cpu" for the compressai format and "accel" for the tpu format,
    whose coder kernels read the parameters on the card. With "cpu" on a
    card, the codec keeps f32 copies on the CPU of the modules the chain
    reads (``models.dc_vic.EntropyChain``): y and the z symbols cross to the
    CPU once per encoded batch, y_hat crosses back once per decoded batch.
    On a model that lies on the CPU both settings are its own chain.

    Numerics: inside each of its calls (``_codec_call``) a Codec runs with
    ``torch.backends.cudnn.allow_tf32 = False``,
    ``torch.backends.cuda.matmul.allow_tf32 = False``,
    ``torch.backends.cudnn.deterministic = True`` and
    ``torch.backends.cudnn.benchmark = False``, and puts the caller's
    settings back when the call returns; constructing one changes nothing.
    cuDNN would otherwise run f32 convolutions in TF32 and may choose
    algorithms per call; a different algorithm between the encode and decode
    chains desynchronizes the stream. The model's ``entropy_precision: default`` re-allows TF32 for
    the entropy-parameter convs only, inside the three chain methods. The
    codec runs under ``torch.no_grad``; the model's ``codec_dtype`` decides
    whether the conv stacks compute in f32 or bf16, the entropy chain is f32
    either way, and both settings travel in the tpu format's header.

    ``mesh``: a list of devices (``parallel.mesh.make_mesh``) to spread each
    batch over: ``Codec(...)`` then builds a ``codec.mesh.MeshCodec`` with
    the same methods, one replica of the model on each entry.
    ``params_backend`` then defaults to "accel", and "cpu" is refused.

    Result dicts: ``string_list`` [header, z_str, y_str], ``num_pixel``,
    ``bpp`` (the container's actual bytes, length fields included),
    ``pred_y_bpp`` / ``pred_z_bpp`` (tpu format, device backend: the
    stream's words x 16 / pixels, exact; host coding: the table cost of the
    symbols, ``rans_device.coded_bits``, flush excluded); with
    ``debug=True`` the encoder's ``y_hat``/``z_hat`` (NHWC numpy) for
    ``verify_roundtrip``.

    Tracing: under a ``torch.profiler`` session the calls mark their
    stages as program spans (``utils/profiling.py::span``, names
    ``codec.*``); the spans of the k-th ``compress_dispatch``, its
    ``compress_finalize``, the k-th ``decompress`` and its ``fetch`` carry
    ``{"seq": k}``."""

    # tiles per launch of the split paths' VQGAN encode and reconstruction:
    # one batch shape whatever the image's size
    _TILE_CHUNK = 16

    def __new__(cls, *args, mesh=None, **kwargs):
        if mesh is None:
            return super().__new__(cls)
        from .mesh import MeshCodec
        return MeshCodec(*args, mesh=mesh, **kwargs)

    def __init__(self, spec, stream_format: str = "tpu", encode_backend: str = "host",
                 lanes: int = 128, portable: bool = False,
                 params_backend: Optional[str] = None, mesh=None):
        if stream_format not in ("tpu", "compressai"):
            raise ValueError(f"stream_format {stream_format!r}: 'tpu' or 'compressai'")
        if encode_backend not in ("host", "device"):
            raise ValueError(f"encode_backend {encode_backend!r}: 'host' or 'device'")
        if params_backend is None:
            params_backend = "cpu" if stream_format == "compressai" else "accel"
        if params_backend not in ("cpu", "accel"):
            raise ValueError(f"params_backend {params_backend!r}: 'cpu' or 'accel'")
        if params_backend == "cpu" and stream_format == "tpu":
            raise ValueError("params_backend='cpu' applies to the compressai stream format: "
                             "the tpu format's coder kernels read the entropy parameters on "
                             "the card")
        rd.check_lanes(lanes)
        self.spec = spec
        self.stream_format = stream_format
        self.encode_backend = encode_backend
        self.lanes = lanes
        self.portable = bool(portable)
        self.params_backend = params_backend
        self.module = spec.module.eval()
        self.device = next(self.module.parameters()).device
        # the module the entropy-parameter chain runs on, and its device
        self._chain = (EntropyChain(self.module)
                       if params_backend == "cpu" and self.device.type != "cpu"
                       else self.module)
        self._chain_device = next(self._chain.parameters()).device
        # uploaded before any decode chain, which never waits: the tpu
        # format's chain runs on the model whatever ``params_backend`` is
        self.module.scale_boundaries(self.device)
        self._chain.scale_boundaries(self._chain_device)
        self.num_slices = self.module.num_slices
        self.bottleneck_y = self.module.bottleneck_y
        # sections of a y stream: one per ChARM slice, or one
        self.y_sections = max(1, self.num_slices)
        self.bottleneck_z = self.module.entropy_model_z.channels
        # the numeric configuration a tpu-format header records and a
        # decoder must share
        self._fast_entropy = (self.module.entropy_precision or "high") != "high"
        self._bf16 = self.module.codec_dtype == "bfloat16"
        if stream_format == "compressai" and self._fast_entropy:
            warnings.warn(
                "stream_format='compressai' with entropy_precision="
                f"'{self.module.entropy_precision}': parity streams are only guaranteed "
                "with entropy_precision='high' (the fast entropy-parameter mode is scoped "
                "to the tpu stream format)", stacklevel=2)
        self.z_table = build_bottleneck_cdf(self.module.entropy_model_z)
        self.y_table = self.module.gaussian.build_cdf_table(get_scale_table())
        self._dtables: Dict[Tuple[str, torch.device], rd.DeviceCdfTable] = {}
        self._workers = min(16, os.cpu_count() or 1)
        # sequence numbers of encode batches and decode requests (span args)
        self._batches, self._requests = itertools.count(), itertools.count()

    def _dtable(self, which: str, device=None) -> rd.DeviceCdfTable:
        """The y or z table on ``device`` (default: the model's), built at
        first use."""
        dev = torch.device(device) if device is not None else self.device
        if (which, dev) not in self._dtables:
            host = self.y_table if which == "y" else self.z_table
            self._dtables[which, dev] = rd.DeviceCdfTable(host, dev)
        return self._dtables[which, dev]

    def _beta_tensors(self, beta_rate: float, beta_vq: float):
        return (torch.tensor([beta_rate], dtype=torch.float32, device=self.device),
                torch.tensor([beta_vq], dtype=torch.float32, device=self.device))

    def _betas(self, quality_ind: int):
        return self._beta_tensors(*self.spec.quality_betas(quality_ind))

    def _resolve_betas(self, quality_ind, beta_rate, beta_vq):
        """(quality the header records, beta_rate, beta_vq): a quality
        level's pair, or betas given as such, recorded as quality 0."""
        if quality_ind is not None:
            return (quality_ind, *self.spec.quality_betas(quality_ind))
        if beta_rate is None or beta_vq is None:
            raise ValueError("give quality_ind, or both beta_rate and beta_vq")
        return 0, float(beta_rate), float(beta_vq)

    def _tpu_y_sections(self, Cy: int) -> List[Tuple[int, int]]:
        """Channel ranges of the y stream's sections in decode order: one
        per ChARM slice, or all of y without ChARM."""
        sc = Cy // self.y_sections
        return [(s * sc, (s + 1) * sc) for s in range(self.y_sections)]

    # ------------------------------------------------------- split paths
    def _chunks(self, tiles: List[torch.Tensor]):
        """Tile batches of ``_TILE_CHUNK``: the tiles' [B] blocks in
        position-major order, the last chunk filled up with copies of the
        first tile, as the reference does."""
        flat = torch.cat(tiles, dim=0)
        pad = (-flat.shape[0]) % self._TILE_CHUNK
        if pad:
            flat = torch.cat([flat] + [flat[:1]] * pad, dim=0)
        return flat.split(self._TILE_CHUNK, dim=0), flat.shape[0] - pad

    def _split_vq_encode(self, x: torch.Tensor):
        """Tiled VQGAN encode of padded NHWC images on the device whose
        larger side exceeds SPLIT_RESOLUTION: 512 px tiles at stride 256,
        encoded in chunks, their pre-quant latents stitched by
        overlap-discard (``tiling.keep_region``), then one quantize of the
        whole latent. Returns (latent, indices) as ``vq_encode`` does."""
        B, H, W, _ = x.shape
        tops = tile_starts(H, ENC_WINDOW, ENC_STRIDE)
        lefts = tile_starts(W, ENC_WINDOW, ENC_STRIDE)
        chunks, n = self._chunks([x[:, t:t + ENC_WINDOW, l:l + ENC_WINDOW]
                                  for t in tops for l in lefts])
        lat = torch.cat([self.module.vq_encode_tile(c.permute(0, 3, 1, 2))
                         for c in chunks], dim=0)[:n]
        f = VQ_STRIDE
        tops8, lefts8, w8 = [t // f for t in tops], [l // f for l in lefts], ENC_WINDOW // f
        canvas = torch.zeros((B, lat.shape[1], H // f, W // f), dtype=lat.dtype,
                             device=lat.device)
        k = 0
        for i, t in enumerate(tops8):
            t0, t1 = keep_region(tops8, i, w8, ENC_STRIDE // f, H // f)
            for j, l in enumerate(lefts8):
                l0, l1 = keep_region(lefts8, j, w8, ENC_STRIDE // f, W // f)
                canvas[:, :, t0:t1, l0:l1] = lat[k * B:(k + 1) * B, :, t0 - t:t1 - t,
                                                 l0 - l:l1 - l]
                k += 1
        return self.module.vq_quantize(canvas)

    def _split_reconstruct(self, y_hat: torch.Tensor, b1, b2) -> torch.Tensor:
        """Tiled reconstruction of y_hat [B, C, yH, yW] on the device: 32 x
        32 y cells (512 px) at stride 16, reconstructed in chunks and
        stitched by overlap-discard into the padded uint8 image [B, 3,
        16 yH, 16 yW], as ``reconstruct_uint8`` returns it. Waits for
        nothing."""
        B, _, yH, yW = y_hat.shape
        tops = tile_starts(yH, DEC_WINDOW_Y, DEC_STRIDE_Y)
        lefts = tile_starts(yW, DEC_WINDOW_Y, DEC_STRIDE_Y)
        chunks, n = self._chunks([y_hat[:, :, t:t + DEC_WINDOW_Y, l:l + DEC_WINDOW_Y]
                                  for t in tops for l in lefts])
        img = torch.cat([self.module.reconstruct_uint8(c, b1, b2) for c in chunks], dim=0)[:n]
        px = Y_STRIDE
        canvas = torch.zeros((B, 3, yH * px, yW * px), dtype=torch.uint8, device=img.device)
        k = 0
        for i, t in enumerate(tops):
            t0, t1 = keep_region(tops, i, DEC_WINDOW_Y, DEC_STRIDE_Y, yH)
            for j, l in enumerate(lefts):
                l0, l1 = keep_region(lefts, j, DEC_WINDOW_Y, DEC_STRIDE_Y, yW)
                canvas[:, :, t0 * px:t1 * px, l0 * px:l1 * px] = img[
                    k * B:(k + 1) * B, :, (t0 - t) * px:(t1 - t) * px,
                    (l0 - l) * px:(l1 - l) * px]
                k += 1
        return canvas

    def _reconstruct(self, y_hat: torch.Tensor, b1, b2, H: int, W: int) -> torch.Tensor:
        """uint8 [B, 3, padH, padW] of an H x W image's y_hat (H x W padded
        or not), tiled where ``_tiled`` says so."""
        with span("codec.reconstruct"):
            if _tiled(H, W):
                return self._split_reconstruct(y_hat, b1, b2)
            return self.module.reconstruct_uint8(y_hat, b1, b2)

    # ------------------------------------------------------------ encode
    def _front(self, x: torch.Tensor, b1, b2):
        """encode_front of padded NHWC images on the device, with the VQGAN
        encode tiled where ``_tiled`` says so."""
        with span("codec.front"):
            if _tiled(x.shape[1], x.shape[2]):
                latent, indices = self._split_vq_encode(x)
                return self.module.encode_front_from_vq(x.permute(0, 3, 1, 2), latent,
                                                        indices, b1, b2)
            return self.module.encode_front(x.permute(0, 3, 1, 2), b1, b2)

    def _encode_param_chain(self, y, z_sym):
        """The decoder's own chain, driven with the encoder's symbols: over
        the whole batch, or in portable mode per image at the batch-1 shape
        (``_split``), the per-slice integers joined back into batch planes.
        Runs where the chain's module lies (``params_backend``). Returns
        (per-slice symbols, per-slice indexes, y_hat, z_hat)."""
        with span("codec.encode_chain"):
            y, z_sym = y.to(self._chain_device), z_sym.to(self._chain_device)
            chain = _ParamChain(self._chain, z_sym, y.shape[2:], self.portable)
            ys = _split(y, self.portable)
            syms, idxs = [], []
            for i in range(self.y_sections):
                idxs.append(chain.indexes())
                syms.append(chain.symbolize(i, ys))
                chain.step(i, syms[-1])
            return syms, idxs, chain.y_hat(), chain.z_hat()

    def _tpu_pack(self, y_sym, y_idx, z_sym) -> Dict:
        """Device entropy encode of the symbol planes (NCHW int16 / uint8):
        one exact pack per stream kind, escapes and tier-2 words included.
        Returns the packed word buffers and one int32 stats tensor
        [6, B]: y words, z words, largest per-section y escapes, z escapes,
        y tier-2 escapes, z tier-2 escapes."""
        with span("codec.pack"):
            py, y_off, y_counts, y_esc, y_big = rd.encode_pack(
                y_sym, y_idx, self.y_sections, self.lanes, self._dtable("y"))
            pz, z_off, z_counts, z_esc, z_big = rd.encode_pack(
                z_sym, None, 1, self.lanes, self._dtable("z"))
            stats = torch.stack([y_counts, z_counts, y_esc.max(dim=1).values,
                                 z_esc.max(dim=1).values, y_big, z_big]).to(torch.int32)
        return dict(packed_y=py, y_offsets=y_off, packed_z=pz, z_offsets=z_off, stats=stats)

    def _encode_tail(self, x: torch.Tensor, b1, b2, fmt: str, debug: bool) -> Dict:
        """Front, parameter chain and the format's tail, queued on the
        device without waiting (with the CPU chain the chain waits for the
        front). ``x``: padded NHWC images on the device."""
        y, z_sym = self._front(x, b1, b2)
        syms, idxs, y_hat, z_hat = self._encode_param_chain(y, z_sym)
        out = dict(max_abs_y=torch.max(torch.abs(y_hat)))
        if fmt == "tpu_dev":
            out.update(self._tpu_pack(torch.cat(syms, dim=1), torch.cat(idxs, dim=1),
                                      row_major(z_sym)))
        else:
            z_sym = z_sym.to(self._chain_device)
            out.update(syms=syms, idxs=idxs, z_sym=z_sym)
            dev = z_sym.device
            B, Cz = z_sym.shape[:2]
            out["y_bits"] = rd.coded_bits(torch.cat(syms, dim=1), torch.cat(idxs, dim=1),
                                          self._dtable("y", dev))
            out["z_bits"] = rd.coded_bits(
                z_sym, rd.channel_rows(B, Cz, *z_sym.shape[2:], dev), self._dtable("z", dev))
        if debug:
            out.update(y_hat=y_hat, z_hat=z_hat)
        return out

    @_codec_call
    def compress_dispatch(self, images: np.ndarray, quality_ind: Optional[int] = None,
                          beta_rate: Optional[float] = None, beta_vq: Optional[float] = None,
                          debug: bool = False) -> Dict:
        """Phase 1: queue the device encode and return a handle for
        ``compress_finalize`` without waiting for the device. Dispatching
        batch k + 1 before finalizing batch k overlaps device compute with
        the host's work. images: [B, H, W, 3] uint8, or float in [-1, 1]
        (unpadded). The betas are a quality level's pair, or given as
        ``beta_rate`` and ``beta_vq`` without a quality (the header then
        records quality 0, as the reference's does)."""
        seq = next(self._batches)
        with span("codec.compress_dispatch", {"seq": seq}):
            images, betas, common = self._dispatch_args(images, quality_ind, beta_rate,
                                                        beta_vq, debug)
            x = self._upload_images(images)
            out = self._encode_tail(x, *self._beta_tensors(*betas), common["fmt"], debug)
        return dict(out=out, B=len(images), encode_batch=len(images), seq=seq, **common)

    def _dispatch_args(self, images, quality_ind, beta_rate, beta_vq, debug):
        """``compress_dispatch``'s arguments checked: (the images, uint8 or
        f32; (beta_rate, beta_vq); the handle's fields other than its batch
        sizes)."""
        quality_ind, beta_rate, beta_vq = self._resolve_betas(quality_ind, beta_rate, beta_vq)
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected [B, H, W, 3] images, got {images.shape}")
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
        fmt = ("compressai" if self.stream_format == "compressai" else
               "tpu_dev" if self.encode_backend == "device" else "tpu_host")
        return images, (beta_rate, beta_vq), dict(H=images.shape[1], W=images.shape[2],
                                                  quality_ind=quality_ind, debug=debug,
                                                  fmt=fmt)

    def _upload_images(self, images: np.ndarray) -> torch.Tensor:
        """NHWC host images, reflect-padded, on this codec's device."""
        return torch.from_numpy(np.ascontiguousarray(_pad_np(images))).to(self.device)

    def _esc_dense_flags(self, H: int, W: int, y_escmax, z_escmax) -> np.ndarray:
        """Per image: some section holds more escapes than ``esc_cap``, so
        the header must free the decoder from that guarantee."""
        _, _, zH, zW, yH, yW = _geometry(H, W)
        lo, hi = self._tpu_y_sections(self.bottleneck_y)[0]
        ny, nz = yH * yW * (hi - lo), zH * zW * self.bottleneck_z
        return ((np.asarray(y_escmax) > rd.esc_cap(ny))
                | (np.asarray(z_escmax) > rd.esc_cap(nz)))

    def _tpu_results(self, handle: Dict, max_abs_y: float, z_strs, y_strs, y_bits, z_bits,
                     escfree, esc_dense, t2free) -> List[Dict]:
        B, H, W = handle["B"], handle["H"], handle["W"]
        results = []
        for b in range(B):
            header = HeaderHandler.encode(
                (H, W), int(max_abs_y), handle["quality_ind"], tpu_format=True, lanes=self.lanes,
                esc_dense=bool(esc_dense[b]), t2free=bool(t2free), escfree=bool(escfree[b]),
                portable=self.portable, encode_batch=handle["encode_batch"],
                fast_entropy=self._fast_entropy, bf16=self._bf16)
            strings = [header, z_strs[b], y_strs[b]]
            results.append(dict(
                string_list=strings, num_pixel=H * W,
                bpp=8.0 * sum(4 + len(s) for s in strings) / (H * W),
                pred_y_bpp=float(y_bits[b]) / (H * W), pred_z_bpp=float(z_bits[b]) / (H * W)))
        return results

    def _finalize_tpu(self, handle: Dict, max_abs_y: float) -> List[Dict]:
        """Fetch the device-coded streams: the stats, then each buffer's
        real words in one copy."""
        out = handle["out"]
        stats = _host(out["stats"]).astype(np.int64)
        y_counts, z_counts, y_escmax, z_escmax, y_big, z_big = stats

        def fetch(packed, offsets, counts):
            offsets = _host(offsets)
            if (counts < 0).any() or (offsets + counts > packed.numel()).any():
                raise RuntimeError("tpu-format stream word counts exceed the packed "
                                   "buffer: corrupt encode stats")
            words = _host(torch.cat([packed[o:o + n] for o, n in zip(offsets, counts)]))
            ends = np.cumsum(counts)
            return [words[e - n:e].tobytes() for e, n in zip(ends, counts)]

        y_strs = fetch(out["packed_y"], out["y_offsets"], y_counts)
        z_strs = fetch(out["packed_z"], out["z_offsets"], z_counts)
        return self._tpu_results(
            handle, max_abs_y, z_strs, y_strs, y_counts * 16.0, z_counts * 16.0,
            escfree=(y_escmax == 0) & (z_escmax == 0),
            esc_dense=self._esc_dense_flags(handle["H"], handle["W"], y_escmax, z_escmax),
            t2free=not (y_big.any() or z_big.any()))

    def _finalize_host(self, handle: Dict, max_abs_y: float) -> List[Dict]:
        """Symbol planes to the host, then the host coder of the format."""
        out = handle["out"]
        B, H, W = handle["B"], handle["H"], handle["W"]
        tpu = handle["fmt"] == "tpu_host"

        def slice_major(planes):  # per image: section, then (h, w, c) order
            return _host(torch.stack([p.permute(0, 2, 3, 1) for p in planes], dim=1)
                         .reshape(B, self.y_sections, -1).to(torch.int32))
        y_sym, y_idx = slice_major(out["syms"]), slice_major(out["idxs"])
        z_np = _nhwc(out["z_sym"]).astype(np.int32).reshape(B, -1)
        y_bits, z_bits = _host(out["y_bits"]), _host(out["z_bits"])
        Cz = self.bottleneck_z
        z_idx = np.broadcast_to(np.arange(Cz, dtype=np.int32),
                                (z_np.shape[1] // Cz, Cz)).reshape(-1)
        with ThreadPoolExecutor(self._workers) as pool:
            if tpu:
                L = rd.section_lanes(y_sym.shape[2], self.lanes)
                Lz = rd.section_lanes(z_np.shape[1], self.lanes)
                z_enc = list(pool.map(lambda b: tpu_encode_sections(
                    [(z_np[b].reshape(-1, Lz), z_idx.reshape(-1, Lz))], self.z_table, True),
                    range(B)))
                y_enc = list(pool.map(lambda b: tpu_encode_sections(
                    [(y_sym[b, s].reshape(-1, L), y_idx[b, s].reshape(-1, L))
                     for s in range(self.y_sections)], self.y_table, True), range(B)))
            else:
                z_strs = list(pool.map(lambda b: encode_with_indexes(
                    z_np[b], z_idx, self.z_table), range(B)))
                y_strs = list(pool.map(lambda b: encode_with_indexes(
                    y_sym[b].reshape(-1), y_idx[b].reshape(-1), self.y_table), range(B)))
        if tpu:
            y_esc = np.array([e for _, e, _ in y_enc])
            z_esc = np.array([e for _, e, _ in z_enc])
            # per image, as the host coder sees one stream at a time
            return self._tpu_results(
                handle, max_abs_y, [s for s, _, _ in z_enc], [s for s, _, _ in y_enc], y_bits,
                z_bits,
                escfree=(y_esc == 0) & (z_esc == 0),
                esc_dense=self._esc_dense_flags(H, W, y_esc, z_esc),
                t2free=not any(t for _, _, t in y_enc + z_enc))
        results = []
        for b in range(B):
            header = HeaderHandler.encode((H, W), max_abs_y, handle["quality_ind"],
                                          portable=self.portable)
            strings = [header, z_strs[b], y_strs[b]]
            results.append(dict(string_list=strings, num_pixel=H * W,
                                bpp=8.0 * sum(4 + len(s) for s in strings) / (H * W),
                                pred_y_bpp=float(y_bits[b]) / (H * W),
                                pred_z_bpp=float(z_bits[b]) / (H * W)))
        return results

    @_codec_call
    def compress_finalize(self, handle: Dict) -> List[Dict]:
        """Phase 2: fetch the device-coded streams (tpu format, device
        backend), or the symbol planes and entropy-code them on the host.
        Returns one result dict per image."""
        with span("codec.compress_finalize", {"seq": handle.get("seq")}):
            return self._finalize(handle, float(_host(handle["out"]["max_abs_y"])))

    def _finalize(self, handle: Dict, max_abs_y: float) -> List[Dict]:
        """``compress_finalize`` with the headers' largest |y| given (a
        mesh's, merged over its shards)."""
        results = (self._finalize_tpu(handle, max_abs_y) if handle["fmt"] == "tpu_dev"
                   else self._finalize_host(handle, max_abs_y))
        if handle["debug"]:
            y_hat, z_hat = _nhwc(handle["out"]["y_hat"]), _nhwc(handle["out"]["z_hat"])
            for b, r in enumerate(results):
                r["y_hat"], r["z_hat"] = y_hat[b], z_hat[b]
        return results

    def compress(self, images: np.ndarray, quality_ind: Optional[int] = None,
                 beta_rate: Optional[float] = None, beta_vq: Optional[float] = None,
                 debug: bool = False) -> List[Dict]:
        """images: [B, H, W, 3] uint8, or float in [-1, 1] (unpadded), at a
        quality level or at given betas (``compress_dispatch``). Returns one
        result dict per image."""
        return self.compress_finalize(
            self.compress_dispatch(images, quality_ind, beta_rate, beta_vq, debug))

    # ------------------------------------------------------------ decode
    def _parse(self, string_lists, run_B: Optional[int] = None) -> Dict:
        """Headers of one decode batch, checked to agree with each other
        and with this codec, the decode running at batch ``run_B`` (default:
        the streams'). Returns the first header's fields, with the tpu
        format's per-stream guarantees merged over the batch."""
        headers = [HeaderHandler.decode(s[0]) for s in string_lists]
        first = dict(headers[0])
        for h in headers:
            if any(h[k] != first[k] for k in ("img_size", "quality_ind", "stream_format",
                                              "lanes")):
                raise ValueError("a decode batch must share image size, quality, stream "
                                 "format and lanes")
            if h["portable"] != first["portable"]:
                raise ValueError("mixed portable and non-portable streams in one decode "
                                 "batch")
        if first["stream_format"] != "tpu":
            return first
        run_B = run_B or len(string_lists)
        for h in headers:
            # the numeric configuration changes the entropy parameters a
            # stream was coded with; a decoder built otherwise would desync
            # silently (headers of 8 bytes or fewer carry no record)
            for key, mine, knob in (("fast_entropy", self._fast_entropy, "entropy_precision"),
                                    ("bf16", self._bf16, "codec_dtype")):
                if h[key] is not None and h[key] != mine:
                    raise ValueError(
                        f"stream was encoded with {knob} "
                        f"{'fast/bf16' if h[key] else 'high/f32'} but this codec is built "
                        f"with the other setting: the entropy parameters would not "
                        f"reproduce and the decode would desync")
            eb = h["encode_batch"]
            if not h["portable"] and eb and eb != run_B:
                raise ValueError(
                    f"non-portable tpu stream was encoded at batch {eb} but this decode "
                    f"runs at batch {run_B}: another batch shape may pick other "
                    f"convolution algorithms and the entropy parameters may not "
                    f"reproduce. Decode in groups of {eb}, or encode with "
                    f"Codec(portable=True) for streams that decode in any grouping")
        first["esc_dense"] = any(bool(h["esc_dense"]) for h in headers)
        first["t2free"] = all(bool(h["t2free"]) for h in headers)
        first["escfree"] = all(bool(h["escfree"]) for h in headers)
        return first

    def _decode_latents(self, z_strs, y_strs, H: int, W: int, portable: bool = False):
        """compressai format: entropy-decode z and the sections of y (the
        ChARM slices, or y whole) on the host, the parameter chain where
        ``params_backend`` puts it; returns (y_hat, z_hat) there. The symbol
        decode is per image either way; ``portable`` runs the parameter
        chain per image too."""
        B = len(z_strs)
        _, _, zH, zW, yH, yW = _geometry(H, W)
        Cz = self.bottleneck_z
        z_idx = np.broadcast_to(np.arange(Cz, dtype=np.int32), (zH, zW, Cz)).reshape(-1)
        dev = self._chain_device
        with ThreadPoolExecutor(self._workers) as pool:
            z_np = np.stack(list(pool.map(
                lambda s: decode_with_indexes(s, z_idx, self.z_table)
                .reshape(zH, zW, Cz), z_strs)))
            chain = _ParamChain(self._chain, _nchw_tensor(z_np, dev), (yH, yW), portable)
            decoders = [RansDecoder(s) for s in y_strs]
            for i in range(self.y_sections):
                idx_np = _nhwc(chain.indexes()).astype(np.int32)
                sc = idx_np.shape[-1]
                sym = np.stack(list(pool.map(
                    lambda b: decoders[b].decode_stream(idx_np[b].reshape(-1), self.y_table)
                    .reshape(yH, yW, sc), range(B))))
                chain.step(i, _nchw_tensor(sym, dev))
        return chain.y_hat(), chain.z_hat()

    def _tpu_caps(self, B: int, yH: int, yW: int, zH: int, zW: int, lanes: int):
        """Most words the y and z buffers of a batch can hold."""
        yN, zN = yH * yW * self.bottleneck_y, zH * zW * self.bottleneck_z
        Ly = rd.section_lanes(yN // self.y_sections, lanes)
        return (B * rd.word_capacity(yN, Ly),
                B * rd.word_capacity(zN, rd.section_lanes(zN, lanes)))

    def _upload_words(self, strings: List[bytes], cap: int):
        """Host bytes -> (device word buffer, all streams back to back;
        per-image word offsets int32). More words than the geometry can
        hold means the streams belong to another (B, resolution, lanes)."""
        lens = np.array([len(s) // 2 for s in strings], np.int64)
        n = int(lens.sum())
        if n > cap:
            raise ValueError(
                f"stream words ({n}) exceed the decode capacity ({cap}) for this "
                "geometry: the streams do not belong to this (B, resolution, lanes) "
                "configuration")
        base = (np.cumsum(lens) - lens).astype(np.int32)
        words = np.frombuffer(b"".join(s[:2 * k] for s, k in zip(strings, lens)), np.int16)
        return (torch.from_numpy(words.copy()).to(self.device),
                torch.from_numpy(base).to(self.device))

    def _decode_pipeline(self, z_words, z_base, y_words, y_base, B: int, zH: int, zW: int,
                         yH: int, yW: int, lanes: int, sparse_esc: bool, recon: bool,
                         b1, b2, tier2: bool = True, escfree: bool = False,
                         portable: bool = False) -> Dict:
        """tpu-format decode as one chain on the device: z section decode ->
        hyper_decode -> per y section (section decode -> the chain's step) ->
        optional reconstruction (tiled where ``_tiled`` says so). Cursors and lane
        states stay on the device and nothing here waits for it. With
        ``portable`` the float chain runs per image (``_split``) while the
        section decodes, which are integer programs, and the reconstruction
        stay batched: B times the chain's launches, no wait more. Returns
        {y_hat, z_hat, consumed_words [2, B] (z, y)[, img uint8 NCHW]}."""
        dev = self.device
        flags = dict(sparse_esc=sparse_esc, tier2=tier2, escfree=escfree)
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        with span("codec.decode.chain"):
            z_sym, z_cursor, _ = rd.decode_section(
                z_words, z_base, zero, None, None, (B, self.bottleneck_z, zH, zW), lanes,
                self._dtable("z"), **flags)
            # the tpu format's parameters were derived on the model's device
            # (``params_backend`` places only the compressai format's chain)
            chain = _ParamChain(self.module, z_sym, (yH, yW), portable)
            sc = self.bottleneck_y // self.y_sections
            cursor, state = zero, None
            for i in range(self.y_sections):
                with span("codec.decode.section"):
                    sym, cursor, state = rd.decode_section(
                        y_words, y_base, cursor, state, chain.indexes(), (B, sc, yH, yW),
                        lanes, self._dtable("y"), **flags)
                    chain.step(i, sym)
        y_hat = chain.y_hat()
        res = dict(y_hat=y_hat, z_hat=chain.z_hat(),
                   consumed_words=torch.stack([z_cursor, cursor], dim=0))
        if recon:
            res["img"] = self._reconstruct(y_hat, b1, b2, yH * Y_STRIDE, yW * Y_STRIDE)
        return res

    def _upload_tpu(self, z_strs: List[bytes], y_strs: List[bytes], img_size: Tuple[int, int],
                    lanes: int) -> Tuple[torch.Tensor, ...]:
        """The word buffers of a tpu-format decode on the device, and the
        coder's tables, before the chain (which never waits)."""
        with span("codec.upload"):
            _, _, zH, zW, yH, yW = _geometry(*img_size)
            y_cap, z_cap = self._tpu_caps(len(z_strs), yH, yW, zH, zW, lanes)
            y_words, y_base = self._upload_words(y_strs, y_cap)
            z_words, z_base = self._upload_words(z_strs, z_cap)
            self._dtable("y"), self._dtable("z")
        return z_words, z_base, y_words, y_base

    def _tpu_chain(self, words, z_strs, y_strs, img_size: Tuple[int, int], b1, b2,
                   lanes: int, esc_dense: bool, t2free: bool, escfree: bool, portable: bool,
                   include_latents: bool = False, seq: Optional[int] = None):
        """Queue the decode chain on uploaded words (``_upload_tpu``).
        Returns a ``PendingImages`` of the pixels and the consumed-word
        counts (``seq``: the request's sequence number), or with
        ``include_latents`` (chain's dict, its check), no reconstruction."""
        H, W = img_size
        B = len(z_strs)
        padH, padW, zH, zW, yH, yW = _geometry(H, W)
        out = self._decode_pipeline(
            *words, B, zH, zW, yH, yW, lanes, sparse_esc=not esc_dense,
            recon=not include_latents, b1=b1, b2=b2, tier2=not t2free, escfree=escfree,
            portable=portable)

        def check(consumed):
            self._check_consumed(consumed, z_strs, y_strs)
        if include_latents:
            return out, check
        flat = torch.cat([out["img"].permute(0, 2, 3, 1).reshape(-1),
                          out["consumed_words"].reshape(-1).view(torch.uint8)])
        return PendingImages(flat, (B, padH, padW, H, W), check, seq)

    def _decompress_tpu(self, z_strs: List[bytes], y_strs: List[bytes],
                        img_size: Tuple[int, int], b1, b2, lanes: int, esc_dense: bool,
                        t2free: bool, escfree: bool, portable: bool,
                        defer_fetch: bool = False, include_latents: bool = False,
                        seq: Optional[int] = None):
        """Decode device-coded streams: upload the word buffers, run the
        decode chain, bring the pixels and the consumed-word counts back in
        one copy. ``include_latents`` returns the chain's dict instead
        (checked), without reconstruction."""
        words = self._upload_tpu(z_strs, y_strs, img_size, lanes)
        got = self._tpu_chain(words, z_strs, y_strs, img_size, b1, b2, lanes, esc_dense,
                              t2free, escfree, portable, include_latents, seq)
        if include_latents:
            out, check = got
            check(_host(out["consumed_words"]))
            return out
        return got if defer_fetch else got.fetch()

    @staticmethod
    def _check_consumed(consumed, z_strs: List[bytes], y_strs: List[bytes]) -> None:
        """Stream-integrity check: the decoder must have consumed exactly
        the words each stream holds (flush, renorm and side-channel words
        account for every word the encoder wrote). A truncated, corrupt or
        mismatched stream desynchronises the renormalisation pattern and
        fails here instead of decoding to garbage pixels."""
        got = np.asarray(consumed)  # [2, B]: final (z, y) cursors
        if np.any(got >= rd.ESC_POISON):
            raise RuntimeError(
                "tpu-format decode poison: a section has more escapes than its header "
                "allows, or an escape or tier-2 marker appeared in a stream whose "
                "header certifies there is none: corrupt stream or mis-flagged encoder")
        want_z = np.array([len(s) // 2 for s in z_strs], got.dtype)
        want_y = np.array([len(s) // 2 for s in y_strs], got.dtype)
        if not (np.array_equal(got[0], want_z) and np.array_equal(got[1], want_y)):
            raise RuntimeError(
                "tpu-format stream integrity check failed: decode consumed "
                f"z={got[0].tolist()} / y={got[1].tolist()} words, streams contain "
                f"z={want_z.tolist()} / y={want_y.tolist()}: corrupt or mismatched bitstream")

    @_codec_call
    def decompress(self, string_lists: List[List[bytes]], defer_fetch: bool = False):
        """Decode same-size, same-quality streams as one batch: of the size
        they were encoded at, or of any size if they are portable (all or
        none of a batch). Returns images [B, H, W, 3] uint8. With
        ``defer_fetch`` a tpu-format decode returns a ``PendingImages``
        whose ``fetch()`` gives the images later, so that the copy overlaps
        the next batch's compute."""
        hdr = self._parse(string_lists)
        tpu = hdr["stream_format"] == "tpu"
        return self.decompress_raw(
            [s[1] for s in string_lists], [s[2] for s in string_lists], hdr["img_size"],
            *self.spec.quality_betas(hdr["quality_ind"]), defer_fetch=defer_fetch,
            stream_format=hdr["stream_format"], lanes=hdr["lanes"],
            esc_dense=tpu and hdr["esc_dense"], portable=bool(hdr["portable"]),
            t2free=tpu and hdr["t2free"], escfree=tpu and hdr["escfree"])

    @_codec_call
    def decompress_raw(self, z_strs: List[bytes], y_strs: List[bytes],
                       img_size: Tuple[int, int], beta_rate: float, beta_vq: float,
                       defer_fetch: bool = False, stream_format: Optional[str] = None,
                       lanes: Optional[int] = None, esc_dense: bool = False,
                       portable: bool = False, t2free: bool = False,
                       escfree: bool = False):
        """Decode z and y strings without their headers, at the given betas
        (streams written by ``compress`` with betas instead of a quality),
        as ``decompress`` does after it has read and checked the headers.
        ``stream_format`` defaults to this codec's; the tpu format's
        ``lanes`` to this codec's lanes, and its guarantees (``esc_dense``,
        ``t2free``, ``escfree``) to none."""
        seq = next(self._requests)
        with span("codec.decompress", {"seq": seq}):
            H, W = img_size
            b1, b2 = self._beta_tensors(beta_rate, beta_vq)
            if (stream_format or self.stream_format) == "tpu":
                return self._decompress_tpu(
                    z_strs, y_strs, (H, W), b1, b2, lanes or self.lanes, esc_dense=esc_dense,
                    t2free=t2free, escfree=escfree, portable=portable,
                    defer_fetch=defer_fetch, seq=seq)
            y_hat, _ = self._decode_latents(z_strs, y_strs, H, W, portable)
            img = self._reconstruct(y_hat.to(self.device), b1, b2, H, W)
            return _nhwc(img[:, :, :H, :W])

    @_codec_call
    def verify_roundtrip(self, results: List[Dict], string_lists: List[List[bytes]],
                         img_size: Tuple[int, int]) -> bool:
        """True when the decoder's y_hat and z_hat equal the encoder's
        bitwise. ``results`` come from ``compress(..., debug=True)``;
        ``img_size`` is the original (H, W)."""
        hdr = self._parse(string_lists)
        H, W = hdr["img_size"]
        if tuple(img_size) != (H, W):
            raise ValueError(f"img_size {img_size} != header size {(H, W)}")
        y_hat, z_hat = self._latents([s[1] for s in string_lists],
                                     [s[2] for s in string_lists], (H, W), hdr)
        return all(np.array_equal(y_hat[b], r["y_hat"])
                   and np.array_equal(z_hat[b], r["z_hat"])
                   for b, r in enumerate(results))

    def _latents(self, z_strs, y_strs, img_size: Tuple[int, int], hdr: Dict):
        """The decoded (y_hat, z_hat) of the streams, NHWC host arrays."""
        if hdr["stream_format"] == "tpu":
            out = self._decompress_tpu(
                z_strs, y_strs, img_size, None, None, hdr["lanes"] or self.lanes,
                esc_dense=hdr["esc_dense"], t2free=hdr["t2free"], escfree=hdr["escfree"],
                portable=bool(hdr["portable"]), include_latents=True)
            y_hat, z_hat = out["y_hat"], out["z_hat"]
        else:
            y_hat, z_hat = self._decode_latents(z_strs, y_strs, *img_size,
                                                bool(hdr["portable"]))
        return _nhwc(y_hat), _nhwc(z_hat)
