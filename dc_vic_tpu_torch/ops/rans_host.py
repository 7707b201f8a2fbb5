"""ctypes binding of the host rANS coder for the compressai stream format.

Port of the compressai-format part of ``dc_vic_tpu/ops/rans/__init__.py``:
``CdfTable``, ``encode_with_indexes``, ``decode_with_indexes`` and
``RansDecoder``. The library is built from the JAX package's
``rans.cpp`` (see ``ops/native.py``), so both packages write the same bytes.
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
