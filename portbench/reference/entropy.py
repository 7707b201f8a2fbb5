"""The entropy coding of the DC-VIC tpu stream format, in NumPy: the
quantised CDF tables (compressai's ``pmf_to_quantized_cdf``, the mean-scale
Gaussian's 64 rows, the factorised bottleneck's rows per channel) and a
decoder of the interleaved 32-bit rANS stream.

Stream layout (one stream per image, y or z): ``[2L flush words]`` then per
section ``[renorm words in (step, lane) order | one tier-1 word per escape |
two tier-2 words per escape whose tier-1 word is 0xFFFF]``. Lane states are
32-bit with lower bound 2^16, probabilities 16-bit, and the lanes of one
stream advance in lockstep, their renormalisations reading the shared word
stream in lane order. A section of an NCHW plane [sc, H, W] is coded in the
NHWC flatten, position p at step p // L, lane p % L. A value outside its
row is coded as the row's last bin, its zigzag payload in the side channel.

Nothing here imports the program; the tables are built from the weights
the benchmark made.
"""
from __future__ import annotations

import math
import struct
from typing import List, Tuple

import numpy as np
from scipy.special import erfc
from scipy.stats import norm

PRECISION = 16
RANS_L = 1 << 16
TIER1_MARKER = 0xFFFF
M16, M32 = 0xFFFF, 0xFFFFFFFF


def pmf_to_quantized_cdf(pmf: np.ndarray) -> np.ndarray:
    """A PMF (tail mass last) -> integer CDF of len + 1 summing to 2^16,
    zero bins repaired from the narrowest bin wider than 1."""
    cdf = np.zeros(len(pmf) + 1, np.uint64)
    cdf[1:] = np.floor(pmf * (1 << PRECISION) + 0.5).astype(np.uint64)
    total = int(cdf.sum())
    cdf = np.cumsum(((1 << PRECISION) * cdf) // np.uint64(total), dtype=np.uint64)
    cdf[-1] = 1 << PRECISION
    cdf = cdf.astype(np.int64)
    freq = np.diff(cdf)
    for i in np.flatnonzero(freq == 0):
        j = int(np.argmin(np.where(freq > 1, freq, np.iinfo(np.int64).max)))
        if j < i:
            cdf[j + 1:i + 1] -= 1
        else:
            cdf[i + 1:j + 1] += 1
        freq[j] -= 1
        freq[i] += 1
    return cdf


def _rows(pmf, tail, lengths, width):
    out = np.zeros((len(lengths), width + 2), np.int64)
    for r, n in enumerate(lengths):
        out[r, :n + 2] = pmf_to_quantized_cdf(np.concatenate([pmf[r, :n], [tail[r]]]))
    return out


def gaussian_table(scales: np.ndarray, tail_mass: float = 1e-9):
    """(cdfs, lengths, offsets) of the mean-scale Gaussian's rows."""
    s = np.asarray(scales, np.float64)
    center = np.ceil(s * -norm.ppf(tail_mass / 2)).astype(np.int64)
    length = 2 * center + 1
    width = int(length.max())
    samples = np.abs(np.arange(width)[None, :] - center[:, None])
    up = 0.5 * erfc(-((0.5 - samples) / s[:, None]) / np.sqrt(2.0))
    lo = 0.5 * erfc(-((-0.5 - samples) / s[:, None]) / np.sqrt(2.0))
    pmf = np.where(np.arange(width)[None, :] < length[:, None], up - lo, 0.0)
    return _rows(pmf, 2.0 * lo[:, 0], length, width), length + 2, -center


def _sigmoid(x):
    return np.where(x >= 0, 1.0 / (1.0 + np.exp(-np.abs(x))),
                    np.exp(-np.abs(x)) / (1.0 + np.exp(-np.abs(x))))


def bottleneck_table(params: dict):
    """(cdfs, lengths, offsets) of the factorised bottleneck, from its
    parameters as float64 arrays (``_matrix{i}``, ``_bias{i}``,
    ``_factor{i}``, ``quantiles``)."""
    K = sum(1 for k in params if k.startswith("_matrix"))

    def logits(v):
        for i in range(K):
            v = np.matmul(np.logaddexp(0.0, params[f"_matrix{i}"]), v) + params[f"_bias{i}"]
            if i < K - 1:
                v = v + np.tanh(params[f"_factor{i}"]) * np.tanh(v)
        return v
    q = params["quantiles"]
    med = q[:, 0, 1]
    lo_n = np.clip(np.ceil(med - q[:, 0, 0]), 0, None).astype(np.int64)
    hi_n = np.clip(np.ceil(q[:, 0, 2] - med), 0, None).astype(np.int64)
    length = lo_n + hi_n + 1
    width = int(length.max())
    C = len(med)
    samples = (np.arange(width)[None, :] + (med - lo_n)[:, None]).reshape(C, 1, -1)
    lower, upper = logits(samples - 0.5), logits(samples + 0.5)
    sign = -np.sign(lower + upper)
    pmf = np.abs(_sigmoid(sign * upper) - _sigmoid(sign * lower)).reshape(C, -1)
    tail = _sigmoid(lower[:, 0, 0]) + _sigmoid(-upper[:, 0, -1])
    pmf = np.where(np.arange(width)[None, :] < length[:, None], pmf, 0.0)
    return _rows(pmf, tail, length, width), length + 2, -lo_n


class Table:
    """A CDF table prepared for decoding: per row the bin of every
    cumulative value (``lut``), each bin's start and frequency, the value of
    bin 0 and the escape bin."""

    def __init__(self, cdfs, lengths, offsets):
        cdfs = np.asarray(cdfs, np.int64)
        self.rows = cdfs.shape[0]
        self.start = cdfs[:, :-1]
        self.freq = np.maximum(cdfs[:, 1:] - cdfs[:, :-1], 1)
        self.offsets = np.asarray(offsets, np.int64)
        self.maxv = np.asarray(lengths, np.int64) - 2
        cum = np.arange(1 << PRECISION)
        self.lut = np.stack([np.searchsorted(cdfs[r, :int(lengths[r])], cum, side="right") - 1
                             for r in range(self.rows)]).astype(np.int64)


def section_lanes(n_symbols: int, cap: int) -> int:
    target = 1
    while target * 2 <= min(cap, max(1, n_symbols // 16)):
        target *= 2
    return math.gcd(n_symbols, target)


class StreamDecoder:
    """Decodes the sections of B streams in lockstep; ``words[b]`` are
    image b's uint16 words. Reads past a stream's end give 0, and
    ``consumed`` counts every word each decode read, so a stream that was
    coded otherwise ends with a count that is not its length."""

    def __init__(self, words: List[np.ndarray]):
        self.B = len(words)
        n = max(len(w) for w in words) + 8
        self.buf = np.zeros((self.B, n), np.int64)
        for b, w in enumerate(words):
            self.buf[b, :len(w)] = w
        self.lengths = np.array([len(w) for w in words], np.int64)
        self.cur = np.zeros(self.B, np.int64)
        self.state = None

    def _read(self, at):
        at = np.clip(at, 0, self.buf.shape[1] - 1)
        return np.take_along_axis(self.buf, at, axis=1)

    def section(self, rows: np.ndarray, table: Table) -> np.ndarray:
        """rows [B, n, L] CDF rows -> symbols [B, n, L] (int64)."""
        B, n, L = rows.shape
        if self.state is None:
            at = self.cur[:, None] + 2 * np.arange(L)[None, :]
            self.state = self._read(at) | (self._read(at + 1) << 16)
            self.cur = self.cur + 2 * L
        x = self.state
        bins = np.empty((B, n, L), np.int64)
        for t in range(n):
            r = rows[:, t]
            cum = x & M16
            s = table.lut[r, cum]
            x = table.freq[r, s] * (x >> 16) + cum - table.start[r, s]
            need = x < RANS_L
            pos = np.cumsum(need, axis=1)
            w = self._read(self.cur[:, None] + pos - 1)
            x = np.where(need, ((x << 16) | w) & M32, x)
            self.cur = self.cur + pos[:, -1]
            bins[:, t] = s
        self.state = x
        maxv, off = table.maxv[rows], table.offsets[rows]
        esc = (bins == maxv).reshape(B, -1)
        sym = (bins + off).reshape(B, -1)
        n_esc = esc.sum(axis=1)
        r1 = np.cumsum(esc, axis=1)
        w1 = self._read(self.cur[:, None] + r1 - 1)
        big = esc & (w1 == TIER1_MARKER)
        r2 = np.cumsum(big, axis=1)
        t2 = (self.cur + n_esc)[:, None]
        raw = np.where(big, self._read(t2 + 2 * r2 - 2) | (self._read(t2 + 2 * r2 - 1) << 16),
                       w1)
        mv, of = maxv.reshape(B, -1), off.reshape(B, -1)
        esc_v = np.where(raw & 1 == 1, -(raw >> 1) - 1, (raw >> 1) + mv) + of
        sym = np.where(esc, esc_v, sym)
        self.cur = self.cur + n_esc + 2 * r2[:, -1]
        return sym.reshape(B, n, L)

    def exact(self) -> np.ndarray:
        """Per stream: every word read, and no more."""
        return self.cur == self.lengths


def to_stream(plane: np.ndarray, L: int) -> np.ndarray:
    """NCHW [B, sc, H, W] -> [B, steps, L] in the NHWC flatten."""
    return plane.transpose(0, 2, 3, 1).reshape(plane.shape[0], -1, L)


def from_stream(s: np.ndarray, sc: int, H: int, W: int) -> np.ndarray:
    return s.reshape(s.shape[0], H, W, sc).transpose(0, 3, 1, 2)


def parse_header(h: bytes) -> dict:
    """The tpu format's 9-byte header: size, lane cap, quality, encode
    batch and the numeric configuration bits."""
    if len(h) < 9:
        raise ValueError(f"a {len(h)}-byte header is not the tpu format's")
    H, W, b3, qb, eb, cfg = struct.unpack("<HHBBHB", h[:9])
    return dict(H=H, W=W, lanes=1 << (b3 & 0x3F), tpu=bool(qb & 0x80),
                portable=bool(qb & 0x40), quality=qb & 0x3F, encode_batch=eb,
                fast_entropy=bool(cfg & 1), bf16=bool(cfg & 2))


def words_of(s: bytes) -> np.ndarray:
    if len(s) % 2:
        raise ValueError("a tpu-format stream holds whole 16-bit words")
    return np.frombuffer(s, np.uint16).astype(np.int64)


def geometry(H: int, W: int) -> Tuple[int, int, int, int, int, int]:
    """(padH, padW, zH, zW, yH, yW) of an H x W image."""
    pH, pW = -(-H // 64) * 64, -(-W // 64) * 64
    return pH, pW, pH // 64, pW // 64, pH // 16, pW // 16

