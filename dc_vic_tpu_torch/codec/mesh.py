"""Several devices in one process: ``Codec(spec, ..., mesh=devices)`` builds a
``MeshCodec`` (the counterpart of the JAX codec's ``jax.sharding.Mesh``;
``parallel/mesh.py::make_mesh`` gives the list).

A composite of one single-device ``Codec`` per entry of the list, each with
its own replica of the model (a card may appear twice), CDF tables and coder
state. A batch is padded to a multiple of the shard count by repeating its
last image or stream, cut into contiguous shards, and each shard runs the
single-device pipeline on its replica; the pad is dropped from every output.
Nothing is reduced across shards but the header's largest |y| (the batch's,
as on one device); the header records the padded batch, and a non-portable
stream decodes only at that padded batch. Portable streams run their batch-1
chain per image on the image's replica, so they decode bit-exactly with any
mesh or none on the same card class. Every shard's work is queued before the
host waits for any of it: the uploads first (a copy from pageable memory
waits for its stream), then the device chains, then the fetches. The
compressai format's decode waits on the host once per ChARM slice and runs
its shards one after another.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import canonical_device, replicas
from .driver import Codec, PendingImages, _codec_call, _host, _nhwc


class _PendingShards:
    """The shards' ``PendingImages`` of one mesh decode: ``fetch`` joins
    them and drops the pad."""

    def __init__(self, parts: List[PendingImages], keep: int):
        self._parts, self._keep = parts, keep

    def fetch(self) -> np.ndarray:
        return np.concatenate([p.fetch() for p in self._parts])[:self._keep]


def _pad_batch(items, multiple: int):
    """A batch (list or array) padded to a multiple of ``multiple`` by
    repeating its last entry."""
    pad = (-len(items)) % multiple
    if not pad:
        return items
    if isinstance(items, np.ndarray):
        return np.concatenate([items, np.repeat(items[-1:], pad, axis=0)])
    return list(items) + [items[-1]] * pad


class MeshCodec:
    """``Codec``'s methods over the devices of ``mesh``, one single-device
    Codec (``_shards``, in mesh order) each. The arguments are
    ``Codec``'s; ``params_backend`` is "accel" (None means it), "cpu" is
    refused: each shard derives its entropy parameters on its own
    device."""

    def __init__(self, spec, stream_format: str = "tpu", encode_backend: str = "host",
                 lanes: int = 128, portable: bool = False,
                 params_backend: Optional[str] = None, mesh=None):
        if params_backend == "cpu":
            raise ValueError("params_backend='cpu' with a mesh: each shard derives its "
                             "entropy parameters on its own device")
        self.mesh = [canonical_device(d) for d in mesh]
        if not self.mesh:
            raise ValueError("a mesh needs at least one device")
        self._shards = [
            Codec(dataclasses.replace(spec, module=m), stream_format, encode_backend, lanes,
                  portable, params_backend or "accel")
            for m in replicas(spec.module.eval(), self.mesh)]
        first = self._shards[0]
        self.spec, self.module, self.device = spec, first.module, first.device
        self.stream_format, self.encode_backend = stream_format, encode_backend
        self.lanes, self.portable, self.params_backend = lanes, first.portable, "accel"

    # Codec's own, on this class's _parse, decompress_raw, compress_*, _latents
    compress = Codec.compress
    decompress = Codec.decompress
    verify_roundtrip = Codec.verify_roundtrip

    def _pad(self, n: int) -> int:
        """The batch the device pipelines run at: n padded up to a multiple
        of the shard count."""
        return -(-n // len(self._shards)) * len(self._shards)

    def _cut(self, items) -> list:
        """A batch padded (``_pad``) and cut into the shards' contiguous
        parts."""
        items = _pad_batch(items, len(self._shards))
        size = len(items) // len(self._shards)
        return [items[i * size:(i + 1) * size] for i in range(len(self._shards))]

    @_codec_call
    def compress_dispatch(self, images: np.ndarray, quality_ind: Optional[int] = None,
                          beta_rate: Optional[float] = None, beta_vq: Optional[float] = None,
                          debug: bool = False) -> Dict:
        """``Codec.compress_dispatch`` over the shards: every shard's
        uploads (and its coder's tables, which no chain waits for), then
        every shard's device chain."""
        images, betas, common = self._shards[0]._dispatch_args(images, quality_ind, beta_rate,
                                                               beta_vq, debug)
        for c in self._shards:
            c._dtable("y"), c._dtable("z")
        ups = [(c._upload_images(x), *c._beta_tensors(*betas))
               for c, x in zip(self._shards, self._cut(images))]
        return dict(B=len(images), shards=[
            dict(out=c._encode_tail(*up, common["fmt"], debug), B=len(up[0]),
                 encode_batch=self._pad(len(images)), **common)
            for c, up in zip(self._shards, ups)])

    @_codec_call
    def compress_finalize(self, handle: Dict) -> List[Dict]:
        """Each shard's results, the pad dropped; the headers carry the
        whole batch's largest |y|, as on one device."""
        max_abs_y = max(float(_host(h["out"]["max_abs_y"])) for h in handle["shards"])
        results = []
        for c, h in zip(self._shards, handle["shards"]):
            results += c._finalize(h, max_abs_y)
        return results[:handle["B"]]

    def _parse(self, string_lists) -> Dict:
        return self._shards[0]._parse(string_lists, self._pad(len(string_lists)))

    @_codec_call
    def decompress_raw(self, z_strs: List[bytes], y_strs: List[bytes],
                       img_size: Tuple[int, int], beta_rate: float, beta_vq: float,
                       defer_fetch: bool = False, stream_format: Optional[str] = None,
                       lanes: Optional[int] = None, esc_dense: bool = False,
                       portable: bool = False, t2free: bool = False,
                       escfree: bool = False):
        """``Codec.decompress_raw`` over the shards: the batch padded and
        cut, every tpu-format shard's upload, then every chain, then the
        fetches; the pad dropped."""
        keep = len(z_strs)
        zs, ys = self._cut(z_strs), self._cut(y_strs)
        if (stream_format or self.stream_format) != "tpu":
            return np.concatenate([
                c.decompress_raw(z, y, img_size, beta_rate, beta_vq,
                                 stream_format="compressai", portable=portable)
                for c, z, y in zip(self._shards, zs, ys)])[:keep]
        lanes = lanes or self.lanes
        ups = [(c._upload_tpu(z, y, img_size, lanes), *c._beta_tensors(beta_rate, beta_vq))
               for c, z, y in zip(self._shards, zs, ys)]
        pending = _PendingShards([
            c._tpu_chain(w, z, y, img_size, b1, b2, lanes, esc_dense, t2free, escfree, portable)
            for c, (w, b1, b2), z, y in zip(self._shards, ups, zs, ys)], keep)
        return pending if defer_fetch else pending.fetch()

    def _latents(self, z_strs, y_strs, img_size: Tuple[int, int], hdr: Dict):
        """Every shard's decoded (y_hat, z_hat) as NHWC host arrays, pad
        included: tpu-format chains all queued before the first wait."""
        zs, ys = self._cut(z_strs), self._cut(y_strs)
        if hdr["stream_format"] != "tpu":
            lat = [c._latents(z, y, img_size, hdr) for c, z, y in zip(self._shards, zs, ys)]
        else:
            lanes = hdr["lanes"] or self.lanes
            words = [c._upload_tpu(z, y, img_size, lanes)
                     for c, z, y in zip(self._shards, zs, ys)]
            runs = [c._tpu_chain(w, z, y, img_size, None, None, lanes, hdr["esc_dense"],
                                 hdr["t2free"], hdr["escfree"], bool(hdr["portable"]),
                                 include_latents=True)
                    for c, w, z, y in zip(self._shards, words, zs, ys)]
            lat = []
            for out, check in runs:
                check(_host(out["consumed_words"]))
                lat.append((_nhwc(out["y_hat"]), _nhwc(out["z_hat"])))
        return np.concatenate([y for y, _ in lat]), np.concatenate([z for _, z in lat])
