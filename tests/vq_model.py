"""A numpy model of the nearest-codeword kernel K1
(``dc_vic_tpu_torch/csrc/vq_argmin.cu``): its arithmetic, its partition of
the codebook over the lanes of a row, each lane's strict-'<' scan, the
shuffle butterfly that joins the lanes, and its partition of the rows over
blocks and threads. Imports neither JAX nor the JAX package, so the tests
on the card (``tests/test_torch_cuda.py``) use it too."""
import numpy as np

from dc_vic_tpu_torch.ops.vq import LANES, THREADS


def fma32(a, b, c):
    """float32 a * b + c rounded once, as the card's FFMA: the product is
    exact in float64, the sum is taken in float64 rounded to odd (an inexact
    sum with an even last bit moves one ulp toward the exact value), which
    rounds to float32 correctly since 53 >= 2 * 24 + 2."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    t = s - c
    err = (p - t) + (c - (s - t))                     # TwoSum: s + err == p + c exactly
    odd = (s.view(np.int64) & 1) == 1
    s = np.where((err != 0) & ~odd, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def kernel_distances(z, cb):
    """[M, N] float32 distances as the kernel computes them: ||e||^2 by a
    product and three FFMAs, then the four FFMAs of -2z against e from it."""
    z2 = np.float32(-2.0) * np.asarray(z, np.float32)      # exact
    e = np.asarray(cb, np.float32)
    sq = e[:, 0] * e[:, 0]
    for d in (1, 2, 3):
        sq = fma32(e[:, d], e[:, d], sq)
    dist = np.broadcast_to(sq[None, :], (z2.shape[0], e.shape[0]))
    for d in range(4):
        dist = fma32(z2[:, d:d + 1], e[None, :, d], dist)
    return dist


def lane_scan(dist, lanes=LANES):
    """Each lane's (distance, index) after its scan: lane g visits codewords
    g, g + lanes, ... in ascending order and keeps one only where it is
    strictly smaller. A lane that visits none keeps (inf, g)."""
    M, N = dist.shape
    best = np.full((M, lanes), np.inf, np.float32)
    idx = np.tile(np.arange(lanes, dtype=np.int64), (M, 1))
    for k in range(0, N, lanes):
        block = dist[:, k:k + lanes]
        g = block.shape[1]
        take = block < best[:, :g]
        best[:, :g] = np.where(take, block, best[:, :g])
        idx[:, :g] = np.where(take, np.arange(k, k + g), idx[:, :g])
    return best, idx


def butterfly(best, idx):
    """The shuffles that join a row's lanes: at offsets lanes / 2, ..., 1
    each lane takes its xor partner's candidate where that distance is
    smaller, or equal with a lower index. Every lane ends with the same."""
    lanes = best.shape[1]
    off = lanes // 2
    while off:
        partner = np.arange(lanes) ^ off
        ob, oi = best[:, partner], idx[:, partner]
        take = (ob < best) | ((ob == best) & (oi < idx))
        best, idx = np.where(take, ob, best), np.where(take, oi, idx)
        off //= 2
    assert (idx == idx[:, :1]).all()
    return idx[:, 0]


def kernel_argmin(z, cb, lanes=LANES, chunk=4096):
    """The kernel's indices for rows z [M, 4] against cb [N, 4], int32."""
    out = [butterfly(*lane_scan(kernel_distances(z[i:i + chunk], cb), lanes))
           for i in range(0, len(z), chunk)]
    return np.concatenate(out).astype(np.int32) if out else np.zeros(0, np.int32)


def gather_rows(storage, offset, B, HW, strides):
    """The rows [B * HW, 4] the kernel reads from flat ``storage`` at
    ``offset`` through the layout's strides (sb, sd, shw)."""
    sb, sd, shw = strides
    m = np.arange(B * HW)
    base = offset + (m // HW) * sb + (m % HW) * shw
    return np.stack([storage[base + d * sd] for d in range(4)], axis=1)


def thread_rows(M, R, threads=THREADS, lanes=LANES):
    """{(block, thread): rows it holds, those under M}: row0 = block *
    (threads / lanes) R + thread / lanes, then row0 + r threads / lanes."""
    groups = threads // lanes
    blocks = -(-M // (groups * R))
    out = {}
    for b in range(blocks):
        for t in range(threads):
            row0 = b * groups * R + t // lanes
            out[b, t] = [row0 + r * groups for r in range(R) if row0 + r * groups < M]
    return out
