"""Where the coder kernels' time goes inside one launch, on the card.

    python3 -m dc_vic_tpu_torch.tools.rans_stamps

Nsight does not run on every machine. This writes an instrumented copy of
the package's ``csrc/rans_device.cu`` with ``clock64()`` stamps into a
``__device__`` array, builds it with nvcc into the port's build directory,
runs R1 over the six-section y stream of 768x512 images ([B, 192, 48, 32],
seeded symbols without escapes) and R2 over its first section, at batch 4
and 16 and lane caps 128 and 512 (R2 also at one warp: batch 1, 32 lanes),
and prints where the time goes: R2's step in four segments, in cycles
averaged over the warps (the LUT lookup; the pair lookup and the state
update; the warps' exchange; the word read), and R1's four launches by
device time (torch.profiler). The anchors below follow R2's loop: an edit of
those lines asks for the same edit here.

The stamps cost a few percent of the step. Needs CUDA and nvcc.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

from ..codec.gaussian import GaussianConditional, get_scale_table
from ..ops import native
from ..ops import rans_device as rd

Y = (16, 192, 48, 32)        # the planes; the timed batches are slices
SECTIONS = 6
TIMED = ((4, 128), (4, 512), (16, 128), (16, 512))      # (batch, lane cap)
SOURCE = os.path.join(native.CSRC, "rans_device.cu")

PROLOGUE = """namespace {
__device__ unsigned long long g_stamps[1 << 16];
__device__ __forceinline__ long long clk() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}
__device__ __forceinline__ void use(uint32_t v) {  // waits until v has landed
  uint32_t d;
  asm volatile("mov.b32 %0, %1;" : "=r"(d) : "r"(v) : "memory");
}
"""
READER = """
extern "C" int dcvic_read_stamps(void* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, n * sizeof(unsigned long long)));
}
"""
R2_SLOT = 4096        # R2's segments from g_stamps[R2_SLOT + (b * 32 + warp) * 4]
SEGMENT_END = """  if ((threadIdx.x & 31) == 0)
    for (int k = 0; k < 4; ++k) g_stamps[4096 + (b * 32 + (threadIdx.x >> 5)) * 4 + k] = seg[k];
"""

# (anchor, replacement) pairs; each anchor occurs once in the source
PATCHES = [
    ("  for (int it = 0; it < iters; ++it) {\n    if (rounds > 1) x = xs[r * T + tid];\n",
     "  long long seg[4] = {0, 0, 0, 0};\n  for (int it = 0; it < iters; ++it) {\n"
     "    long long c0 = clk();\n    if (rounds > 1) x = xs[r * T + tid];\n"),
    ("    const int bin = __ldcg(lut + (static_cast<size_t>(rw) << 16) + cum);\n",
     "    const int bin = __ldcg(lut + (static_cast<size_t>(rw) << 16) + cum);\n"
     "    use(bin);\n    long long c1 = clk();\n"),
    ("    x = (pr >> 16) * (x >> 16) + cum - (pr & 0xFFFFu);\n",
     "    x = (pr >> 16) * (x >> 16) + cum - (pr & 0xFFFFu);\n"
     "    use(x);\n    long long c2 = clk();\n"),
    ("    warp_exchange(__popc(bn) | (__popc(be) << 16), warp_cnt[buf], &before, &all);\n",
     "    warp_exchange(__popc(bn) | (__popc(be) << 16), warp_cnt[buf], &before, &all);\n"
     "    use(all);\n    long long c3 = clk();\n"),
    ("    cur += all & 0xFFFFu;\n    n_esc += all >> 16;\n    buf ^= 1;\n",
     "    cur += all & 0xFFFFu;\n    n_esc += all >> 16;\n    buf ^= 1;\n    use(x);\n"
     "    long long c4 = clk();\n    seg[0] += c1 - c0; seg[1] += c2 - c1; "
     "seg[2] += c3 - c2; seg[3] += c4 - c3;\n"),
    ("  if (rounds == 1 && on) xs[tid] = x;\n",
     SEGMENT_END + "  if (rounds == 1 && on) xs[tid] = x;\n"),
]
SEGMENTS = ("LUT", "pair + state", "exchange", "word")


def instrument(source: str = SOURCE) -> str:
    src = open(source).read()
    for old, new in [("namespace {\n", PROLOGUE)] + PATCHES:
        if src.count(old) != 1:
            raise ValueError(f"{source} has moved from the stamps' anchors: {old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src + READER


def build() -> ctypes.CDLL:
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    cu = os.path.join(native.BUILD_DIR, "rans_stamps.cu")
    lib = os.path.join(native.BUILD_DIR, "librans_stamps.so")
    with open(cu, "w") as f:
        f.write(instrument())
    subprocess.run([native._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-diag-suppress", "177,550", "-Xcompiler", "-fPIC", "-shared", "-o",
                    lib, cu], check=True)
    out = ctypes.CDLL(lib)
    out.dcvic_read_stamps.restype = ctypes.c_int
    out.dcvic_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return out


def stamps(lib, n: int) -> np.ndarray:
    buf = (ctypes.c_ulonglong * n)()
    native.check(lib.dcvic_read_stamps(ctypes.addressof(buf), n), "read_stamps")
    return np.frombuffer(buf, dtype=np.uint64).astype(np.int64)


def time_ms(fn, reps=20) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def planes(table, dev):
    """Symbols inside their rows' ranges around the middle bin, rows drawn
    at random, seed 0."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(table.offsets), Y)
    maxv = (np.asarray(table.cdf_lengths) - 2)[idx]
    value = np.clip(np.round(maxv // 2 + rng.normal(0, 1, Y) * np.maximum(maxv // 6, 1)),
                    0, maxv - 1)
    sym = (value + np.asarray(table.offsets)[idx]).astype(np.int16)
    return torch.from_numpy(sym).to(dev), torch.from_numpy(idx.astype(np.uint8)).to(dev)


def r2_cases(sym, idx, dtable):
    """(label, batch, lanes, words, base, first section's indexes) for R2."""
    out = []
    for B, lanes in ((1, 32),) + TIMED:
        packed, offsets, counts, _, _ = rd.encode_pack(sym[:B], idx[:B], SECTIONS, lanes, dtable)
        words = torch.cat([packed[int(o):int(o) + int(n)] for o, n in zip(offsets, counts)])
        base = (torch.cumsum(counts, 0) - counts).to(torch.int32)
        out.append((B, rd.section_lanes(Y[1] // SECTIONS * Y[2] * Y[3], lanes), words, base,
                    idx[:B, :Y[1] // SECTIONS].contiguous()))
    return out


def report_r2(lib, B, L, ms):
    steps = Y[1] // SECTIONS * Y[2] * Y[3] // L
    warps = max(1, min(L, 1024) // 32)
    seg = stamps(lib, R2_SLOT + B * 32 * 4)[R2_SLOT:].reshape(B, 32, 4)[:, :warps]
    mean = seg.astype(np.float64).mean(axis=(0, 1)) / steps
    parts = ", ".join(f"{name} {v:.0f}" for name, v in zip(SEGMENTS, mean))
    print(f"R2 batch {B}, lanes {L} ({steps} steps): {ms:.4f} ms, {ms / steps * 1e3:.3f} us a "
          f"step; cycles a step: {parts} (sum {mean.sum():.0f})")


def run(lib, sym, idx, dtable):
    from torch.profiler import ProfilerActivity, profile
    from ..utils.profiling import kernel_times
    real = native.kernels()
    for name in ("dcvic_rans_encode_pack", "dcvic_rans_decode_section"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, getattr(real, name).argtypes
    cases = r2_cases(sym, idx, dtable)
    native._libs["libdcvic_kernels.so"] = lib           # the wrappers launch the copy
    try:
        for B, L, words, base, idx0 in cases:
            zero = torch.zeros(B, dtype=torch.int32, device=sym.device)
            ms = time_ms(lambda: rd.decode_section(words, base, zero, None, idx0,
                                                   (B, Y[1] // SECTIONS, Y[2], Y[3]), L, dtable))
            report_r2(lib, B, L, ms)
    finally:
        native._libs["libdcvic_kernels.so"] = real
    for B, lanes in TIMED:
        enc = lambda: rd.encode_pack(sym[:B], idx[:B], SECTIONS, lanes, dtable)
        ms = time_ms(enc)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                enc()
            torch.cuda.synchronize()
        parts = ", ".join(f"{k.split('rans_encode_')[1].split('_kernel')[0]} {us / 1e4:.4f}"
                          for k, (us, _) in sorted(kernel_times(prof).items())
                          if "rans_encode_" in k)
        print(f"R1 batch {B}, lane cap {lanes}: {ms:.4f} ms; launches by device time "
              f"(ms): {parts}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("rans_stamps: CUDA is not available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    table = GaussianConditional().build_cdf_table(get_scale_table())
    dtable = rd.DeviceCdfTable(table, dev)
    sym, idx = planes(table, dev)
    run(build(), sym, idx, dtable)
    return 0


if __name__ == "__main__":
    sys.exit(main())
