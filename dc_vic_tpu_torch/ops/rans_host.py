"""ctypes binding of the host rANS coder, both stream formats.

Port of ``dc_vic_tpu/ops/rans/__init__.py``: ``CdfTable``, the compressai
format's ``encode_with_indexes``, ``decode_with_indexes`` and
``RansDecoder``, and the tpu format's ``tpu_encode_sections`` and
``tpu_decode_stream`` (the interleaved 32-bit coder that
``ops/rans_device.py`` runs on the card; this one is ``encode_backend="host"``
and the byte oracle of the device coder). The library is built from
``csrc/rans.cpp``, the port's copy of the JAX package's source (see
``ops/native.py``), so both packages write the same bytes.
"""
from __future__ import annotations

import numpy as np

from . import native


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).reshape(-1), dtype=np.int32)


class CdfTable:
    """Quantized CDF rows (each summing to 1 << 16), per-row lengths and
    symbol offsets, prepared into a native handle with dense decode LUTs."""

    def __init__(self, cdfs, cdf_lengths, offsets):
        self.cdfs = np.ascontiguousarray(cdfs, dtype=np.int32)
        self.cdf_lengths = _as_i32(cdf_lengths)
        self.offsets = _as_i32(offsets)
        rows = self.cdfs.shape[0]
        if (self.cdfs.ndim != 2 or len(self.cdf_lengths) != rows
                or len(self.offsets) != rows):
            raise ValueError("cdfs [rows, cols], cdf_lengths [rows] and "
                             "offsets [rows] do not agree")
        self._lib = native.rans()
        self._h = self._lib.dcvic_rans_table_new(
            self.cdfs.ctypes.data, rows, self.cdfs.shape[1],
            self.cdf_lengths.ctypes.data, self.offsets.ctypes.data)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dcvic_rans_table_free(self._h)
            self._h = None


def encode_with_indexes(symbols, indexes, table: CdfTable) -> bytes:
    """One rANS stream of ``symbols`` coded with CDF rows ``indexes``."""
    lib = native.rans()
    symbols = _as_i32(symbols)
    indexes = _as_i32(indexes)
    n = len(symbols)
    if len(indexes) != n:
        raise ValueError(f"{n} symbols but {len(indexes)} indexes")
    cap = 16 * n + 64
    while True:
        out = np.empty(cap, dtype=np.uint8)
        r = lib.dcvic_rans_encode_with_indexes(
            symbols.ctypes.data, indexes.ctypes.data, n, table._h,
            out.ctypes.data, cap)
        if r >= 0:
            return out[:r].tobytes()
        cap = -r + 64


def decode_with_indexes(stream: bytes, indexes, table: CdfTable) -> np.ndarray:
    """Decode ``len(indexes)`` symbols of one stream; returns int32."""
    lib = native.rans()
    indexes = _as_i32(indexes)
    n = len(indexes)
    buf = np.frombuffer(stream, dtype=np.uint8).copy()
    out = np.empty(n, dtype=np.int32)
    lib.dcvic_rans_decode_with_indexes(
        buf.ctypes.data, len(buf), indexes.ctypes.data, n, table._h,
        out.ctypes.data)
    return out


ESC_HAS_TIER2 = 1 << 28  # flag bit of the coder's esc_max output (kEscHasTier2)


def _sections_2d(arrays):
    """[n_i, L] int32 arrays of one stream -> (flat concatenation, per-section
    step counts, L)."""
    flat, steps, L = [], [], None
    for a in arrays:
        a = np.ascontiguousarray(a, dtype=np.int32)
        if a.ndim != 2 or (L is not None and a.shape[1] != L):
            raise ValueError("sections of one stream are [n, L] with one L")
        L = a.shape[1]
        flat.append(a.reshape(-1))
        steps.append(a.shape[0])
    return np.concatenate(flat), np.asarray(steps, np.int32), L


def tpu_encode_sections(sections, table: CdfTable, return_esc_max: bool = False):
    """Host encoder of the tpu stream format, byte-identical to the device
    coder. ``sections``: (symbols [n, L], indexes [n, L]) pairs in decode
    order, one L. Lane states chain across the sections: one 2L-word flush
    per stream. With ``return_esc_max`` returns (bytes, largest per-section
    escape count, whether a tier-2 word was written)."""
    lib = native.rans()
    sym, steps, L = _sections_2d([s for s, _ in sections])
    idx, steps_i, L_i = _sections_2d([i for _, i in sections])
    if L != L_i or not np.array_equal(steps, steps_i):
        raise ValueError("symbols and indexes of a section differ in shape")
    cap = 2 * L + 4 * sym.size + 16   # flush, then renorm + tier-1 + 2 tier-2 each
    out = np.empty(cap, dtype=np.uint16)
    esc_max = np.zeros(1, dtype=np.int32)
    r = lib.dcvic_tpu_encode_stream(
        sym.ctypes.data, idx.ctypes.data, steps.ctypes.data, len(steps), L,
        table._h, out.ctypes.data, cap, esc_max.ctypes.data)
    if r < 0:
        raise RuntimeError(f"tpu stream encode needs {-r} words, capacity {cap}")
    data = out[:r].tobytes()
    if not return_esc_max:
        return data
    raw = int(esc_max[0])
    return data, raw & ~ESC_HAS_TIER2, bool(raw & ESC_HAS_TIER2)


def tpu_decode_stream(words, index_sections, table: CdfTable):
    """Host decoder of a whole chained tpu-format stream. ``words``: uint16
    array; ``index_sections``: [n, L] index arrays in decode order. Returns
    (list of symbols [n, L] int32, words consumed). Reads past the end give
    zero words."""
    lib = native.rans()
    idx, steps, L = _sections_2d(index_sections)
    words = np.ascontiguousarray(words, dtype=np.uint16)
    out = np.empty(idx.size, dtype=np.int32)
    used = lib.dcvic_tpu_decode_stream(
        words.ctypes.data, len(words), idx.ctypes.data, steps.ctypes.data,
        len(steps), L, table._h, out.ctypes.data)
    bounds = np.concatenate([[0], np.cumsum(steps.astype(np.int64) * L)])
    return [out[bounds[i]:bounds[i + 1]].reshape(int(n), L)
            for i, n in enumerate(steps)], used


class RansDecoder:
    """Streaming decoder over one rANS stream (the per-slice ChARM decode
    reads it in several calls)."""

    def __init__(self, stream: bytes):
        self._lib = native.rans()
        self._buf = np.frombuffer(stream, dtype=np.uint8).copy()
        self._h = self._lib.dcvic_rans_decoder_new(self._buf.ctypes.data,
                                                   len(self._buf))

    def decode_stream(self, indexes, table: CdfTable) -> np.ndarray:
        indexes = _as_i32(indexes)
        out = np.empty(len(indexes), dtype=np.int32)
        self._lib.dcvic_rans_decode_stream(
            self._h, indexes.ctypes.data, len(indexes), table._h,
            out.ctypes.data)
        return out

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dcvic_rans_decoder_free(self._h)
            self._h = None
