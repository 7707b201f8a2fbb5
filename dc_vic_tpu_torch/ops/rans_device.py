"""Interleaved 32-bit rANS on the card: the coder of the "tpu" stream format.

Port of ``dc_vic_tpu/ops/rans_device.py``. The scheme is the reference's:
32-bit lane states, 16-bit renormalisation words, 16-bit probabilities, L
lanes that advance in lockstep and share one word stream in (step, lane)
order, so the decoder's renormalisation pattern reproduces the encoder's
emission pattern and no per-lane length is stored. One stream is all ChARM
slices of one image's y, or its z; one section is one slice. Lane states
chain across the sections of a stream (they are encoded last to first), so
a stream pays one 2L-word flush:

  [2L flush words][sec0: renorm (step, lane) order | tier-1 | tier-2][sec1 ...]

An escape (a value outside its CDF row) takes the row's last bin in the
rANS stream and its zigzag payload in a side channel behind the section's
renorm words: one tier-1 word per escape (the payload, or the 0xFFFF marker),
then two tier-2 words (low, high) per marked escape.

What is here:

* ``DeviceCdfTable``: the quantised CDF rows on the device, as a packed
  (start | freq << 16) table for the encoder and a 2^16-entry cum -> bin
  table per row (uint16) for the decoder.
* The plain PyTorch versions ``encode_stream_plain``, ``pack_streams_plain``
  and ``decode_section_plain``, in the reference's stream-order layout
  ``[B, steps, L]``. They run on any device, a Python loop over the steps.
* ``encode_pack`` and ``decode_section``: the entry points the codec calls,
  on the model's NCHW tensors. A CPU tensor takes the plain versions; a CUDA
  tensor launches kernel R1 resp. R2 of ``csrc/rans_device.cu``; anything
  else raises. ``encode_scratch`` gives kernel R1's scratch sizes.
* ``coded_bits``: the exact cost of coding given symbols, for reporting.

Words are uint16 and states uint32 in the stream; tensors hold them as the
same bits in int16 and int32 (PyTorch has little unsigned arithmetic), and
the plain versions compute in int64 and mask.

Stream order of an NCHW section ``[B, sc, H, W]`` is the NHWC flatten:
position ``p = (h * W + w) * sc + c``, step ``p // L``, lane ``p % L``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import native

PRECISION = 16
RANS_L = 1 << 16          # state lower bound; a state lies in [2^16, 2^32)
LANES = 128               # default cap on interleaved lanes per stream
TIER1_MARKER = 0xFFFF     # tier-1 word of an escape whose payload needs tier 2
WORST_WORDS_PER_SYM = 4   # renorm + tier-1 + 2 tier-2
ESC_POISON = 1 << 26      # added to a cursor when a header guarantee is violated
MAX_LANES = 4096

# Kernel launches since the last reset (counted where a kernel launches).
launches = {"rans_encode_pack": 0, "rans_decode_section": 0}

_M16 = 0xFFFF
_M32 = 0xFFFFFFFF


def esc_cap(n_symbols: int) -> int:
    """Most escapes a section of ``n_symbols`` may hold unless its header
    sets the dense-escape flag: the encoder flags streams that exceed it, and
    a decoder that meets more without the flag poisons the cursor."""
    return min(n_symbols, max(1024, n_symbols // 8))


def section_lanes(n_symbols: int, cap: int = LANES) -> int:
    """Lane count of a section: a power-of-two divisor of ``n_symbols``, at
    most ``cap``, and small enough that each lane carries 16 symbols or more
    (the flush costs 4 bytes per lane)."""
    target = 1
    while target * 2 <= min(cap, max(1, n_symbols // 16)):
        target *= 2
    return math.gcd(n_symbols, target)


def check_lanes(lanes: int) -> None:
    if lanes & (lanes - 1) or not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"lane cap {lanes} is not a power of two in [1, {MAX_LANES}]")


def _wrap(x: torch.Tensor, bits: int, dtype: torch.dtype) -> torch.Tensor:
    """The low ``bits`` of int64 ``x`` as the signed type of that width."""
    half = 1 << (bits - 1)
    return (((x & ((1 << bits) - 1)) ^ half) - half).to(dtype)


def _u16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M16


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


class DeviceCdfTable:
    """CDF rows of a host ``CdfTable`` on ``device``.

    ``pair[row * cols + bin] = start | freq << 16`` (uint32 bits in int32;
    bins past a row's length hold freq 1); ``lut[row, cum] = bin`` (uint16
    bits in int16) for every cum in [0, 2^16); ``offsets[row]`` is the symbol
    value of bin 0 and ``maxv[row]`` the escape bin. ``pair_packed`` holds
    the valid bins of every row back to back, row r's from ``pair_base[r]``
    (zero-padded to a multiple of four entries): kernel R2 copies it into
    shared memory, or reads it from global memory when it does not fit."""

    def __init__(self, table, device):
        cdfs = np.asarray(table.cdfs, np.int64)
        lengths = np.asarray(table.cdf_lengths, np.int64)
        offsets = np.asarray(table.offsets, np.int64)
        rows, cols = cdfs.shape
        if np.abs(offsets).max() >= 1 << 15 or (lengths - 2).max() >= 1 << 14:
            raise ValueError("CDF table outside the coder's range")
        self.rows, self.cols = rows, cols - 1
        starts = cdfs[:, :-1]
        freqs = cdfs[:, 1:] - cdfs[:, :-1]
        valid = np.arange(cols - 1)[None, :] < (lengths - 1)[:, None]
        pair = np.where(valid, starts | (np.maximum(freqs, 1) << 16), 1 << 16)
        cum = np.arange(1 << PRECISION, dtype=np.int64)
        lut = np.empty((rows, 1 << PRECISION), np.uint16)
        for r in range(rows):
            lut[r] = np.searchsorted(cdfs[r, :int(lengths[r])], cum, side="right") - 1
        dev = torch.device(device)
        self.device = dev
        self.pair = torch.from_numpy(pair.astype(np.uint32).view(np.int32).reshape(-1)).to(dev)
        self.lut = torch.from_numpy(lut.view(np.int16)).to(dev)
        self.offsets = torch.from_numpy(offsets.astype(np.int32)).to(dev)
        self.maxv = torch.from_numpy((lengths - 2).astype(np.int32)).to(dev)
        bins = lengths - 1
        packed = pair[valid].astype(np.uint32)
        packed = np.concatenate([packed, np.zeros(-len(packed) % 4, np.uint32)])
        self.pair_packed = torch.from_numpy(packed.view(np.int32)).to(dev)
        self.pair_base = torch.from_numpy((np.cumsum(bins) - bins).astype(np.int32)).to(dev)


# ------------------------------------------------------------ stream order
def to_stream(t: torch.Tensor, L: int) -> torch.Tensor:
    """NCHW ``[B, sc, H, W]`` -> stream order ``[B, steps, L]``."""
    B = t.shape[0]
    return t.permute(0, 2, 3, 1).reshape(B, -1, L)


def from_stream(t: torch.Tensor, sc: int, H: int, W: int) -> torch.Tensor:
    """Stream order ``[B, steps, L]`` -> row-major NCHW ``[B, sc, H, W]``."""
    return t.reshape(t.shape[0], H, W, sc).permute(0, 3, 1, 2).contiguous()


def channel_rows(B: int, C: int, H: int, W: int, device) -> torch.Tensor:
    """The indexes of a factorised stream (z): CDF row = channel. NCHW."""
    return torch.arange(C, device=device, dtype=torch.int64).view(1, C, 1, 1).expand(B, C, H, W)


# ------------------------------------------------------------ plain encode
def _precompute(sym: torch.Tensor, idx: torch.Tensor, table: DeviceCdfTable):
    """Per symbol: (start, freq, escape flag, zigzag payload), int64."""
    idx = idx.to(torch.int64).clamp(0, table.rows - 1)
    off = table.offsets.to(torch.int64)[idx]
    maxv = table.maxv.to(torch.int64)[idx]
    value = sym.to(torch.int64) - off
    esc = (value < 0) | (value >= maxv)
    raw = torch.where(value < 0, -2 * value - 1, 2 * (value - maxv)) & _M32
    value = torch.where(esc, maxv, value)
    pair = _u32(table.pair[(idx * table.cols + value).clamp(0, table.pair.numel() - 1)])
    return pair & _M16, pair >> 16, esc, raw


def coded_bits(sym: torch.Tensor, idx: torch.Tensor, table: DeviceCdfTable) -> torch.Tensor:
    """Exact rANS cost in bits per image, flush excluded: -log2(freq / 2^16)
    per symbol, 16 bits per escape and 32 more per tier-2 escape.
    ``sym``/``idx`` ``[B, ...]`` -> ``[B]`` float32."""
    B = sym.shape[0]
    _, freq, esc, raw = _precompute(sym.reshape(B, -1), idx.reshape(B, -1), table)
    bits = PRECISION - torch.log2(freq.to(torch.float32))
    extra = torch.where(esc, torch.where(raw >= TIER1_MARKER, 48.0, 16.0), 0.0)
    return (bits + extra).sum(dim=1)


def _encode_one(sym, idx, table: DeviceCdfTable, x: torch.Tensor):
    """Reverse-encode one section ``[B, n, L]`` from lane states ``x``
    ``[B, L]`` (int64). Returns (states, vals [B, 4nL], mask, escapes [B],
    tier-2 escapes [B])."""
    B, n, L = sym.shape
    start, freq, esc, raw = _precompute(sym, idx, table)
    w_main = torch.empty((B, n, L), dtype=torch.int64, device=sym.device)
    m_main = torch.empty((B, n, L), dtype=torch.bool, device=sym.device)
    for t in range(n - 1, -1, -1):
        f, s = freq[:, t], start[:, t]
        renorm = x >= (f << 16)
        w_main[:, t] = x & _M16
        m_main[:, t] = renorm
        x = torch.where(renorm, x >> 16, x)
        x = ((torch.div(x, f, rounding_mode="floor") << 16) | (x % f + s)) & _M32
    esc_f, raw_f = esc.reshape(B, -1), raw.reshape(B, -1)
    big_f = esc_f & (raw_f >= TIER1_MARKER)
    t1 = torch.where(big_f, TIER1_MARKER, raw_f) & _M16
    t2 = torch.stack([raw_f & _M16, raw_f >> 16], dim=-1).reshape(B, -1)
    m2 = big_f.repeat_interleave(2, dim=1)
    vals = torch.cat([w_main.reshape(B, -1), t1, t2], dim=1)
    mask = torch.cat([m_main.reshape(B, -1), esc_f, m2], dim=1)
    return x, vals, mask, esc_f.sum(dim=1), big_f.sum(dim=1)


def encode_stream_plain(sections: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                        table: DeviceCdfTable):
    """Plain version of the encoder: ``sections`` is a list of (sym, idx)
    ``[B, n_i, L]`` in decode order with one B and L. Returns (vals [B, K]
    int64 words, mask [B, K], escapes per section [B, S] int32, tier-2
    escapes per image [B] int32) with K = 2L + 4 * sum(n_i) * L; compact with
    ``pack_streams_plain``."""
    B, _, L = sections[0][0].shape
    dev = sections[0][0].device
    x = torch.full((B, L), RANS_L, dtype=torch.int64, device=dev)
    blocks, escs = [], []
    big = torch.zeros(B, dtype=torch.int64, device=dev)
    for sym, idx in reversed(sections):
        if sym.shape[0] != B or sym.shape[2] != L or idx.shape != sym.shape:
            raise ValueError("all sections of one stream share (B, L)")
        x, vals, mask, n_esc, n_big = _encode_one(sym, idx, table, x)
        blocks.append((vals, mask))
        escs.append(n_esc)
        big = big + n_big
    blocks.reverse()
    escs.reverse()
    flush = torch.stack([x & _M16, x >> 16], dim=-1).reshape(B, 2 * L)
    vals = torch.cat([flush] + [v for v, _ in blocks], dim=1)
    mask = torch.cat([torch.ones((B, 2 * L), dtype=torch.bool, device=dev)]
                     + [m for _, m in blocks], dim=1)
    return vals, mask, torch.stack(escs, dim=1).to(torch.int32), big.to(torch.int32)


def pack_streams_plain(vals: torch.Tensor, mask: torch.Tensor):
    """Compact the masked words of each image into one flat buffer, images
    back to back. Returns (packed [B*K] int16 of which the first
    sum(counts) entries mean something, counts [B] int32)."""
    B, K = vals.shape
    pos = torch.cumsum(mask.to(torch.int64), dim=1)
    counts = pos[:, -1]
    base = torch.cumsum(counts, dim=0) - counts
    tgt = torch.where(mask, base[:, None] + pos - 1, B * K)
    packed = torch.zeros(B * K + 1, dtype=torch.int16, device=vals.device)
    packed[tgt.reshape(-1)] = _wrap(vals.reshape(-1), 16, torch.int16)
    return packed[:B * K], counts.to(torch.int32)


# ------------------------------------------------------------ plain decode
def _read_words(words: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """uint16 words at int64 positions ``at``; 0 outside the buffer."""
    n = words.numel()
    if n == 0:
        return torch.zeros_like(at)
    inside = (at >= 0) & (at < n)
    return torch.where(inside, _u16(words[at.clamp(0, n - 1)]), 0)


def decode_section_plain(words: torch.Tensor, img_base: torch.Tensor,
                         cursor: torch.Tensor, state: Optional[torch.Tensor],
                         idx: torch.Tensor, table: DeviceCdfTable,
                         sparse_esc: bool = False, tier2: bool = True,
                         escfree: bool = False):
    """Plain version of the decoder: one section, ``idx`` ``[B, n, L]``.

    ``words``: all images' streams back to back (int16 bits); ``img_base``
    ``[B]``: each stream's start; ``cursor`` ``[B]`` int32: words consumed so
    far in the stream; ``state`` ``[B, L]`` int32 bits from the previous
    section, or None for the first, which reads the 2L flush words.
    The three flags are the header's guarantees, and a stream that breaks
    one gets ``ESC_POISON`` added to its cursor: ``escfree`` (no escape at
    all; escaped positions then hold the escape bin's value), ``tier2=False``
    (no 0xFFFF tier-1 word), ``sparse_esc`` (at most ``esc_cap(n * L)``
    escapes). Reads outside ``words`` give 0.
    Returns (symbols [B, n, L] int32, cursor [B] int32, states [B, L] int32)."""
    B, n, L = idx.shape
    dev = idx.device
    base = img_base.to(torch.int64)
    cur = cursor.to(torch.int64)
    rows = idx.to(torch.int64).clamp(0, table.rows - 1)
    if state is None:
        at = base[:, None] + cur[:, None] + 2 * torch.arange(L, device=dev)
        x = _read_words(words, at) | (_read_words(words, at + 1) << 16)
        cur = cur + 2 * L
    else:
        if state.shape != (B, L):
            raise ValueError(f"state {tuple(state.shape)} for a section of {(B, L)}")
        x = _u32(state)
    lut = table.lut.reshape(-1)
    bins = torch.empty((B, n, L), dtype=torch.int64, device=dev)
    for t in range(n):
        r = rows[:, t]
        cum = x & _M16
        s = _u16(lut[r * (1 << PRECISION) + cum])
        pair = _u32(table.pair[r * table.cols + s])
        x = (pair >> 16) * (x >> 16) + cum - (pair & _M16)
        need = x < RANS_L
        pos = torch.cumsum(need.to(torch.int64), dim=1)
        w = _read_words(words, base[:, None] + cur[:, None] + pos - 1)
        x = torch.where(need, ((x << 16) | w) & _M32, x)
        cur = cur + pos[:, -1]
        bins[:, t] = s
    maxv = table.maxv.to(torch.int64)[rows]
    off = table.offsets.to(torch.int64)[rows]
    esc = bins == maxv
    sym = bins + off
    esc_f = esc.reshape(B, -1)
    n_esc = esc_f.sum(dim=1)
    if escfree:
        cur = cur + ESC_POISON * (n_esc > 0).to(torch.int64)
        return sym.to(torch.int32), cur.to(torch.int32), _wrap(x, 32, torch.int32)
    r1 = torch.cumsum(esc_f.to(torch.int64), dim=1)
    w1 = _read_words(words, base[:, None] + cur[:, None] + r1 - 1)
    big = esc_f & (w1 == TIER1_MARKER)
    if tier2:
        r2 = torch.cumsum(big.to(torch.int64), dim=1)
        t2b = base[:, None] + (cur + n_esc)[:, None]
        lo = _read_words(words, t2b + 2 * r2 - 2)
        hi = _read_words(words, t2b + 2 * r2 - 1)
        raw = torch.where(big, lo | (hi << 16), w1)
        t2_words = 2 * r2[:, -1]
    else:
        raw = w1
        t2_words = ESC_POISON * big.any(dim=1).to(torch.int64)
    raw = raw.reshape(B, n, L)
    esc_v = torch.where(raw & 1 == 1, -(raw >> 1) - 1, (raw >> 1) + maxv) + off
    sym = torch.where(esc, esc_v, sym)
    cur = cur + n_esc + t2_words
    if sparse_esc:
        cur = cur + ESC_POISON * (n_esc > esc_cap(n * L)).to(torch.int64)
    return _wrap(sym, 32, torch.int32), cur.to(torch.int32), _wrap(x, 32, torch.int32)


# ---------------------------------------------------------- entry points
def _check_planes(sym: torch.Tensor, idx: Optional[torch.Tensor], n_sections: int,
                  lanes: int):
    if sym.dim() != 4 or sym.dtype not in (torch.int16, torch.int32):
        raise TypeError("symbols are NCHW int16 or int32")
    B, C, H, W = sym.shape
    if idx is not None and (idx.shape != sym.shape or idx.dtype != torch.uint8
                            or idx.device != sym.device):
        raise TypeError("indexes are NCHW uint8 of the symbols' shape and device")
    if n_sections < 1 or C % n_sections:
        raise ValueError(f"{C} channels do not split into {n_sections} sections")
    check_lanes(lanes)
    sc = C // n_sections
    return B, C, H, W, sc, section_lanes(sc * H * W, lanes)


def word_capacity(n_symbols: int, L: int) -> int:
    """Most words a stream of ``n_symbols`` can take."""
    return 2 * L + WORST_WORDS_PER_SYM * n_symbols


def encode_scratch(B: int, C: int, HW: int, n_sections: int, L: int) -> dict:
    """Scratch of kernel R1 for B images of C channels of HW positions in
    ``n_sections`` sections of L lanes. A lane group is the 32 lanes (all
    L when L < 32) of one step that one warp handles; ``entries`` counts
    them in stream order. ``rec`` holds each symbol's (start, freq), then
    its renorm word; ``masks`` each group's renorm, escape and tier-2
    ballots; ``prefix`` their exclusive prefix sums with the totals last."""
    steps = n_sections * (C // n_sections * HW // L)
    groups = max(1, L // 32)
    entries = steps * groups
    return {"steps": steps, "groups": groups, "entries": entries,
            "rec": (B, C * HW), "masks": (B, 3, entries), "prefix": (B, 3, entries + 1)}


def encode_pack(sym: torch.Tensor, idx: Optional[torch.Tensor], n_sections: int,
                lanes: int, table: DeviceCdfTable):
    """Encode one stream per image and compact it (kernel R1 on a CUDA
    tensor, the plain versions on a CPU tensor).

    ``sym`` NCHW int16 (the model's planes) or int32; section ``s`` is channels ``[s * sc, (s + 1) * sc)``;
    ``idx`` NCHW uint8 CDF rows, or None for a factorised stream (row =
    channel). Returns (packed int16 words, offsets [B] int64, counts [B]
    int32, escapes per section [B, S] int32, tier-2 escapes [B] int32):
    image b's stream is ``packed[offsets[b] : offsets[b] + counts[b]]``."""
    B, C, H, W, sc, L = _check_planes(sym, idx, n_sections, lanes)
    if sym.device.type == "cuda":
        return _encode_pack_cuda(sym, idx, n_sections, sc, L, table)
    if sym.device.type != "cpu":
        raise ValueError(f"encode_pack: unsupported device {sym.device}")
    rows = channel_rows(B, C, H, W, sym.device) if idx is None else idx
    sections = [(to_stream(sym[:, s * sc:(s + 1) * sc], L),
                 to_stream(rows[:, s * sc:(s + 1) * sc], L)) for s in range(n_sections)]
    vals, mask, esc, big = encode_stream_plain(sections, table)
    packed, counts = pack_streams_plain(vals, mask)
    offsets = torch.cumsum(counts.to(torch.int64), dim=0) - counts
    return packed, offsets, counts, esc, big


def decode_section(words: torch.Tensor, img_base: torch.Tensor, cursor: torch.Tensor,
                   state: Optional[torch.Tensor], idx: Optional[torch.Tensor],
                   shape: Tuple[int, int, int, int], lanes: int,
                   table: DeviceCdfTable, sparse_esc: bool = False,
                   tier2: bool = True, escfree: bool = False,
                   out_dtype: torch.dtype = torch.int16):
    """Decode one section of every image's stream (kernel R2 on CUDA
    tensors, the plain version on CPU tensors).

    ``shape`` is the section's (B, sc, H, W); ``idx`` NCHW uint8 of that
    shape, or None for a factorised stream. Other arguments and the poison
    rules as in ``decode_section_plain``. Returns (symbols row-major NCHW of
    ``out_dtype``, cursor [B] int32, states [B, L] int32)."""
    B, sc, H, W = shape
    check_lanes(lanes)
    if idx is not None and (tuple(idx.shape) != tuple(shape) or idx.dtype != torch.uint8):
        raise TypeError(f"indexes are NCHW uint8 of shape {tuple(shape)}")
    if words.dtype != torch.int16 or words.dim() != 1:
        raise TypeError("words are a flat int16 tensor")
    if out_dtype not in (torch.int16, torch.int32):
        raise TypeError("symbols come out as int16 or int32")
    L = section_lanes(sc * H * W, lanes)
    for name, t in (("img_base", img_base), ("cursor", cursor)):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise TypeError(f"{name} is int32 {(B,)}")
    if state is not None and (state.dtype != torch.int32 or tuple(state.shape) != (B, L)):
        raise TypeError(f"state is int32 {(B, L)}")
    dev = words.device
    if dev.type == "cuda":
        return _decode_section_cuda(words, img_base, cursor, state, idx, shape, L, table,
                                    sparse_esc, tier2, escfree, out_dtype)
    if dev.type != "cpu":
        raise ValueError(f"decode_section: unsupported device {dev}")
    rows = channel_rows(B, sc, H, W, dev) if idx is None else idx
    sym, cur, x = decode_section_plain(words, img_base, cursor, state, to_stream(rows, L),
                                       table, sparse_esc, tier2, escfree)
    return from_stream(sym, sc, H, W).to(out_dtype), cur, x


# ------------------------------------------------------------ CUDA wrappers
def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _on(dev, *tensors) -> None:
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")


def _encode_pack_cuda(sym, idx, n_sections: int, sc: int, L: int, table: DeviceCdfTable):
    B, C, H, W = sym.shape
    dev = sym.device
    _on(dev, idx, table.pair, table.offsets, table.maxv)
    sym = sym.contiguous()
    idx = None if idx is None else idx.contiguous()
    if idx is None and C > table.rows:
        raise ValueError("a factorised stream needs one CDF row per channel")
    cap = word_capacity(C * H * W, L)
    packed = torch.empty((B, cap), dtype=torch.int16, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    esc = torch.empty((B, n_sections), dtype=torch.int32, device=dev)
    big = torch.empty(B, dtype=torch.int32, device=dev)
    scratch = encode_scratch(B, C, H * W, n_sections, L)
    rec, masks, prefix = (torch.empty(scratch[k], dtype=torch.int32, device=dev)
                          for k in ("rec", "masks", "prefix"))
    if B:
        lib = native.kernels()
        with torch.cuda.device(dev):
            err = lib.dcvic_rans_encode_pack(
                sym.data_ptr(), int(sym.dtype == torch.int32), _ptr(idx), table.pair.data_ptr(),
                table.offsets.data_ptr(), table.maxv.data_ptr(), table.rows, table.cols, B, C,
                H * W, n_sections, L, rec.data_ptr(), masks.data_ptr(), prefix.data_ptr(),
                scratch["entries"], packed.data_ptr(), cap, counts.data_ptr(), esc.data_ptr(),
                big.data_ptr(), torch.cuda.current_stream().cuda_stream)
        native.check(err, "rans_encode_pack")
        launches["rans_encode_pack"] += 1
    offsets = torch.arange(B, device=dev, dtype=torch.int64) * cap
    return packed.reshape(-1), offsets, counts, esc, big


def _decode_section_cuda(words, img_base, cursor, state, idx, shape, L: int,
                         table: DeviceCdfTable, sparse_esc: bool, tier2: bool,
                         escfree: bool, out_dtype):
    B, sc, H, W = shape
    dev = words.device
    _on(dev, img_base, cursor, state, idx, table.pair, table.lut, table.pair_packed)
    if idx is None and sc > table.rows:
        raise ValueError("a factorised stream needs one CDF row per channel")
    n_sym = sc * H * W
    idx = None if idx is None else idx.contiguous()
    state = None if state is None else state.contiguous()
    words, img_base, cursor = words.contiguous(), img_base.contiguous(), cursor.contiguous()
    out = torch.empty((B, sc, H, W), dtype=out_dtype, device=dev)
    cursor_out = torch.empty(B, dtype=torch.int32, device=dev)
    state_out = torch.empty((B, L), dtype=torch.int32, device=dev)
    esc_pos = torch.empty((B, n_sym), dtype=torch.int32, device=dev)    # scratch
    if B:
        lib = native.kernels()
        flags = (1 if escfree else 0) | (2 if tier2 else 0) | (4 if sparse_esc else 0) \
            | (8 if out_dtype == torch.int16 else 0)
        with torch.cuda.device(dev):
            err = lib.dcvic_rans_decode_section(
                words.data_ptr(), words.numel(), img_base.data_ptr(),
                cursor.data_ptr(), _ptr(state), _ptr(idx),
                table.lut.data_ptr(), table.pair.data_ptr(), table.offsets.data_ptr(),
                table.maxv.data_ptr(), table.pair_packed.data_ptr(), table.pair_base.data_ptr(),
                table.pair_packed.numel(), table.rows, table.cols, B, sc, H * W, L,
                flags, esc_cap(n_sym), esc_pos.data_ptr(),
                out.data_ptr(), cursor_out.data_ptr(), state_out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        native.check(err, "rans_decode_section")
        launches["rans_decode_section"] += 1
    return out, cursor_out, state_out
