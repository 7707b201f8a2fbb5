"""Spatial tiling for high-resolution images (TPU-first redesign).

The reference handles >1024px images with three ad-hoc mechanisms
(ref: hyperprior_vic_model.py:137-246 split VQGAN encode, :413-473 split
decode, vq_fusion_module.py:129-311 fold/unfold windowed attention with
border weighting). Here all three collapse into ONE mechanism: overlapping
fixed-shape tiles batched through the same jitted graphs (one compile per
tile shape), stitched host-side by overlap-discard. Bounding the tile size
also bounds the VQGAN attention length, which is what the reference's
fold/unfold was for.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

SPLIT_RESOLUTION = 1024    # px threshold (ref: SPLIT_DECODE_RESOLUTION)
ENC_WINDOW = 512           # px VQGAN-encode tile (ref: :194 patch_size)
ENC_STRIDE = 256           # px (ref: :193 stride)
DEC_WINDOW_Y = 32          # y-cells = 512 px (ref: SPLIT_WINDOW_SIZE)
DEC_STRIDE_Y = 16          # y-cells = 256 px (ref: SPLIT_STRIDE)


def tile_starts(full: int, window: int, stride: int) -> List[int]:
    """Window start offsets: stride steps, final window flush with the end
    (ref: hyperprior_vic_model.py:199-215 left_list/top_list)."""
    if full <= window:
        return [0]
    starts = []
    s = 0
    while s + window < full:
        starts.append(s)
        s += stride
    starts.append(full - window)
    return starts


def keep_region(starts: List[int], i: int, window: int, stride: int,
                full: int) -> Tuple[int, int]:
    """Overlap-discard: tile boundaries at the midpoints of adjacent tiles'
    overlaps, so the kept bands partition [0, full) exactly even when the
    final (flush) tile is irregularly placed (ref: :225-238)."""
    lo = 0 if i == 0 else (starts[i - 1] + starts[i] + window) // 2
    hi = full if i == len(starts) - 1 \
        else (starts[i] + starts[i + 1] + window) // 2
    return lo, hi


def extract_tiles(x: np.ndarray, window: int, stride: int
                  ) -> Tuple[np.ndarray, List[int], List[int]]:
    """x: [B, H, W, C] -> tiles [T*B, window, window, C] (T tiles, batch-major
    per tile so each [B] block is one tile position)."""
    B, H, W, C = x.shape
    tops = tile_starts(H, window, stride)
    lefts = tile_starts(W, window, stride)
    tiles = [x[:, t:t + window, l:l + window] for t in tops for l in lefts]
    return np.concatenate(tiles, axis=0), tops, lefts


def stitch_tiles(tiles: np.ndarray, out_shape: Tuple[int, ...],
                 tops: List[int], lefts: List[int], window: int, stride: int,
                 scale: int = 1) -> np.ndarray:
    """Inverse of extract_tiles with overlap-discard stitching. tops/lefts/
    window/stride are in INPUT tile units; `scale` maps them to the tile
    arrays' resolution (e.g. 1/8-resolution latents: scale handled by passing
    downscaled units; decoded pixels from y-tiles: scale=16)."""
    B = out_shape[0]
    H, W = out_shape[1], out_shape[2]
    out = np.zeros(out_shape, tiles.dtype)
    k = 0
    for i, t in enumerate(tops):
        for j, l in enumerate(lefts):
            tile = tiles[k * B:(k + 1) * B]
            k += 1
            t_lo, t_hi = keep_region(tops, i, window, stride, H // scale)
            l_lo, l_hi = keep_region(lefts, j, window, stride, W // scale)
            out[:, t_lo * scale:t_hi * scale, l_lo * scale:l_hi * scale] = \
                tile[:, (t_lo - t) * scale:(t_hi - t) * scale,
                     (l_lo - l) * scale:(l_hi - l) * scale]
    return out
