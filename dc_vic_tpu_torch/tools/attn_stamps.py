"""Where the attention kernel K2's time goes inside one launch, on the card.

    python3 -m dc_vic_tpu_torch.tools.attn_stamps [--out FILE]

Nsight does not run on every machine. This writes an instrumented copy of
the package's ``csrc/flash_attn_f32.cu`` with ``clock64()`` stamps into a
``__device__`` array, builds it with nvcc into the port's build directory,
runs it at the shapes of ``SHAPES`` and prints, for thread 0 of each
warpgroup of the first block over two key tiles in the middle of the walk,
the cycles of each segment of a chunk's iteration: the early loads (the
next chunk's raw values, the copy kRaw chunks on), the wait for the
warpgroup's turn, the issue of the products (Q's fragments, split, and the
wgmmas, which wait for the tensor cores while the other warpgroup's
products run), the split of the next chunk into shared memory, the wait for
the products, the adds, the score exchange and softmax (the last K chunk of
a tile), the wait for the copies, and the hand-over (proxy fence and
barrier). The anchors below follow the kernel's loop: an edit of those lines
asks for the same edit here.

The stamps cost a few percent of the time. Needs CUDA and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import native

SOURCE = os.path.join(native.CSRC, "flash_attn_f32.cu")
SHAPES = ((4, 6144, 512), (6, 1024, 128))
FIRST_TILE = 40            # the first of the two key tiles stamped (moved in for short walks)
SEGMENTS = ("loads", "turn", "issue", "split", "wait", "adds", "softmax", "copies", "hand-over")
MAX_CHUNKS = 16            # chunks of a tile at C = 512: the stamp rows a tile

STAMP = ("  if (blockIdx.x == 0 && blockIdx.y == 0 && wtid == 0 && tile >= g_t0 && "
         "tile < g_t0 + 2) {{ long long t_; asm volatile(\"mov.u64 %0, %%clock64;\" : "
         "\"=l\"(t_)::\"memory\"); g_st[wg][(tile - g_t0) * " + str(MAX_CHUNKS) +
         " + qi][{i}] = t_; }}\n")
# (anchor, stamp index, before or after the anchor); each anchor occurs once
ANCHORS = (
    ("      const int s = tile * kPer + qi;\n", 0, "after"),
    ("      if (wg == 1 || s > 0) bar_sync(kBarTurn + wg, kThreads);\n", 1, "before"),
    ("      if (wg == 1 || s > 0) bar_sync(kBarTurn + wg, kThreads);\n", 2, "after"),
    ("      // meanwhile the next chunk into the other split stage\n", 3, "before"),
    ("      tf32x3::wgmma_wait<0>();\n", 4, "before"),
    ("      tf32x3::wgmma_wait<0>();\n", 5, "after"),
    ("      if (qi == kNK - 1) {\n        // ---- the two halves", 6, "before"),
    ("      cp_async_wait<kRaw - 2>();  // chunk s + 2, this thread's part\n", 7, "before"),
    ("      fence_to_async();\n      bar_sync(kBarGroup + wg, 128);", 8, "before"),
    ("      bar_sync(kBarGroup + wg, 128);  // chunk s + 1 is split, s + 2 has landed; s is read\n",
     9, "after"),
)
PROLOGUE = ("namespace {\n__device__ long long g_st[2][%d][%d];\n__device__ int g_t0;\n"
            % (2 * MAX_CHUNKS, len(SEGMENTS) + 1))
READER = """
extern "C" int dcvic_read_attn_stamps(void* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_st, sizeof(g_st)));
}
extern "C" int dcvic_set_attn_stamp_tile(int t0) {
  return static_cast<int>(cudaMemcpyToSymbol(g_t0, &t0, sizeof(int)));
}
"""


def instrument() -> str:
    """The kernel's source with the stamps in place."""
    src = open(SOURCE).read()
    for anchor, i, where in ANCHORS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor {anchor!r} found {src.count(anchor)} times")
        stamp = STAMP.format(i=i)
        src = src.replace(anchor, anchor + stamp if where == "after" else stamp + anchor)
    if src.count("namespace {\n") != 1:
        raise RuntimeError("the source's anonymous namespace moved")
    return src.replace("namespace {\n", PROLOGUE, 1) + READER


def build() -> ctypes.CDLL:
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    cu = os.path.join(native.BUILD_DIR, "flash_attn_stamps.cu")
    so = os.path.join(native.BUILD_DIR, "libflash_attn_stamps.so")
    with open(cu, "w") as f:
        f.write(instrument())
    subprocess.run([native._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-Xcompiler", "-fPIC", "-shared", "-I", native.CSRC, "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dcvic_flash_attn_f32.argtypes = [p, p, p, p, i, i, i, p]
    lib.dcvic_read_attn_stamps.argtypes = [p]
    lib.dcvic_set_attn_stamp_tile.argtypes = [i]
    return lib


def chunks_per_tile(C: int) -> int:
    return C // 64 + C // 128 * 2     # K chunks of 32 channels, V chunks of 16 keys x 64


def stamps(lib, B, N, C, t0):
    """[2 warpgroups][2 tiles x chunks][segments] cycles, and each chunk's
    total from its top to the next chunk's top."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, N, C, generator=gen, device=dev) * C ** -0.5
    k, v = (torch.randn(B, N, C, generator=gen, device=dev) for _ in range(2))
    o = torch.empty_like(q)
    assert lib.dcvic_set_attn_stamp_tile(t0) == 0
    for _ in range(2):
        err = lib.dcvic_flash_attn_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                       B, N, C, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
    torch.cuda.synchronize()
    raw = np.zeros((2, 2 * MAX_CHUNKS, len(SEGMENTS) + 1), np.int64)
    assert lib.dcvic_read_attn_stamps(raw.ctypes.data) == 0
    per = chunks_per_tile(C)
    rows = np.concatenate([raw[:, :per], raw[:, MAX_CHUNKS:MAX_CHUNKS + per]], axis=1)
    seg = np.diff(rows, axis=2)
    total = np.diff(rows[:, :, 0], axis=1)
    return seg, total, per


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the stamps as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_stamps: CUDA is not available; this tool runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    lib = build()
    result = {"device": smi, "segments": SEGMENTS, "shapes": []}
    for B, N, C in SHAPES:
        t0 = min(FIRST_TILE, (N + 31) // 32 - 2)
        seg, total, per = stamps(lib, B, N, C, t0)
        nk = C // 64
        print(f"[{B},{N},{C}]: cycles by segment, thread 0 of each warpgroup of block (0, 0), "
              f"key tiles {t0}-{t0 + 1} ({per} chunks a tile, {nk} of K)")
        print("wg chunk " + " ".join(f"{n:>9s}" for n in SEGMENTS) + "     total")
        for wg in range(2):
            for c in range(2 * per):
                tot = f"{total[wg, c]:9d}" if c < 2 * per - 1 else ""
                cells = " ".join(f"{x:9d}" for x in seg[wg, c])
                print(f"{wg:2d} {c % per:5d} {cells} {tot}")
        is_k = np.array([c % per < nk for c in range(2 * per)])
        mean = {"K": seg[:, is_k].mean(axis=(0, 1)), "V": seg[:, ~is_k].mean(axis=(0, 1))}
        for kind, m in mean.items():
            print(f"   mean of the {kind} chunks: " + ", ".join(
                f"{n} {x:.0f}" for n, x in zip(SEGMENTS, m)))
        result["shapes"].append({"shape": [B, N, C], "tiles": [t0, t0 + 1],
                                 "segments": seg.tolist(), "totals": total.tolist(),
                                 "mean_k": mean["K"].tolist(), "mean_v": mean["V"].tolist()})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
