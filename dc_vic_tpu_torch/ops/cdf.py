"""PMF -> quantized integer CDF tables (offline table building).

Port of dc_vic_tpu/ops/cdf.py: the exact integer algorithm of the
reference's native dependency (compressai._CXX.pmf_to_quantized_cdf).
Bit-exact integer arithmetic matters: the rANS decode is only correct if
encoder and decoder use identical tables. The zero-bin repair searches its
donor bin with numpy instead of a Python loop (same result, the wide
Gaussian rows have thousands of empty tail bins).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

PRECISION = 16


def pmf_to_quantized_cdf(pmf: Sequence[float], precision: int = PRECISION) -> np.ndarray:
    """Quantize a PMF (with its tail mass appended as the final entry) into an
    integer CDF of length len(pmf)+1 summing to 2**precision.

    Zero-frequency bins are repaired by stealing probability mass from the
    lowest-frequency bin that can afford it (freq > 1), matching the native
    algorithm's behavior exactly.
    """
    pmf = np.asarray(pmf, dtype=np.float64)
    if np.any(pmf < 0) or not np.all(np.isfinite(pmf)):
        raise ValueError("pmf entries must be finite and non-negative")

    n = len(pmf)
    cdf = np.zeros(n + 1, dtype=np.uint64)
    # round() here is half-away-from-zero (C++ std::round), not banker's.
    cdf[1:] = np.floor(pmf * (1 << precision) + 0.5).astype(np.uint64)

    total = int(cdf.sum())
    if total == 0:
        raise ValueError("pmf is all zeros")

    # Normalize each entry: floor(2^precision * p / total), then prefix-sum.
    scaled = ((1 << precision) * cdf) // np.uint64(total)
    cdf = np.cumsum(scaled, dtype=np.uint64)
    cdf[-1] = 1 << precision

    cdf = cdf.astype(np.int64)
    # Repair zero-width bins in ascending order, each by stealing one unit
    # from the first of the narrowest bins wider than 1. A repair changes
    # only the donor's width (down to >= 1) and the repaired bin's (to 1),
    # so the zero bins found up front are exactly the ones to repair.
    freq = np.diff(cdf)
    big = np.iinfo(np.int64).max
    for i in np.flatnonzero(freq == 0):
        best_steal = int(np.argmin(np.where(freq > 1, freq, big)))
        if freq[best_steal] <= 1:
            raise ValueError("cannot repair zero-frequency bin")
        if best_steal < i:
            cdf[best_steal + 1 : i + 1] -= 1
        else:
            cdf[i + 1 : best_steal + 1] += 1
        freq[best_steal] -= 1
        freq[i] += 1

    assert cdf[0] == 0 and cdf[-1] == (1 << precision)
    assert np.all(np.diff(cdf) > 0), "CDF must be strictly increasing"
    return cdf.astype(np.int32)


def build_cdf_rows(pmfs: np.ndarray, tail_masses: np.ndarray,
                   pmf_lengths: np.ndarray, max_length: int,
                   precision: int = PRECISION) -> np.ndarray:
    """Build a padded [rows, max_length + 2] int32 CDF matrix.

    Row i quantizes pmfs[i, :pmf_lengths[i]] with tail_masses[i] appended,
    giving a CDF of length pmf_lengths[i] + 2 (the extra final bin is the
    escape slot used for bypass coding).
    """
    rows = pmfs.shape[0]
    out = np.zeros((rows, max_length + 2), dtype=np.int32)
    for i in range(rows):
        L = int(pmf_lengths[i])
        prob = np.concatenate([pmfs[i, :L], [float(tail_masses[i])]])
        cdf = pmf_to_quantized_cdf(prob, precision)
        out[i, : L + 2] = cdf
    return out
