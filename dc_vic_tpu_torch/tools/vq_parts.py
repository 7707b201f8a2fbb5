"""Where the nearest-codeword kernel K1's time goes, part by part, on one GPU.

    python -m dc_vic_tpu_torch.tools.vq_parts

Builds ``csrc/vq_argmin.cu`` as it stands and in three variants made from it
by string replacements in the body of ``scan`` (the work of one
(row, codeword) pair), each into a library of its own, and times all four
through the same C entry at the latents of ``vq_time.VQ_SHAPES`` (the
kernel's own duration under ``torch.profiler``):

* ``kernel``: as built: four FFMAs, then a compare and two selects that keep
  the distance and its index;
* ``min only``: the compare and selects replaced by ``fminf`` (no index);
* ``products only``: the four FFMAs summed into the row's value (one FADD);
* ``reads only``: the codeword reads and two FADDs.

The difference of two neighbours is the time of the part one of them drops;
what ``reads only`` takes is the launch, the rows' and the codebook's loads,
the shared-memory reads and the butterfly. The variants compute no index,
so only ``kernel`` is held, to the port's own build of the same source.
Needs CUDA and nvcc; fails without.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import native, vq
from ..utils.profiling import profiled_ms
from .vq_time import VQ_SHAPES, bound_ms

SOURCE = os.path.join(native.CSRC, "vq_argmin.cu")
# the pair's work in ``scan``, and what each variant puts in its place
PAIR = """    if (d < best[r]) {
      best[r] = d;
      best_n[r] = n;
    }
"""
PRODUCTS = """    float d = fmaf(zr[r].x, e.x, s);
    d = fmaf(zr[r].y, e.y, d);
    d = fmaf(zr[r].z, e.z, d);
    d = fmaf(zr[r].w, e.w, d);
"""
VARIANTS = {
    "kernel": [],
    "min only": [(PAIR, "    best[r] = fminf(best[r], d);\n")],
    "products only": [(PAIR, "    best[r] += d;\n")],
    "reads only": [(PRODUCTS + PAIR, "    best[r] += e.x + s;\n")],
}


def variant_source(name: str, source: str) -> str:
    """``source`` with the replacements of variant ``name``; each anchor
    must occur exactly once."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"{name}: the anchor occurs {source.count(old)} times in the source")
        source = source.replace(old, new)
    return source


def build(name: str, source: str) -> ctypes.CDLL:
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    stem = os.path.join(native.BUILD_DIR, "vq_parts_" + name.replace(" ", "_"))
    with open(stem + ".cu", "w") as f:
        f.write(variant_source(name, source))
    native._run([native._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", stem + ".so", stem + ".cu"],
                os.path.basename(stem))
    lib = ctypes.CDLL(stem + ".so")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dcvic_vq_argmin.restype = i
    lib.dcvic_vq_argmin.argtypes = [p, p, p, i, i, i, ll, ll, ll, i, p]
    return lib


def runner(lib: ctypes.CDLL):
    """A call of ``lib``'s entry on a [B, 4, H, W] latent, as the wrapper
    makes it."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def run(z, cb):
        z, B, HW, strides = vq.nchw_layout(z)
        out = torch.empty(B * HW, dtype=torch.int32, device=z.device)
        native.check(lib.dcvic_vq_argmin(
            z.data_ptr(), cb.data_ptr(), out.data_ptr(), B * HW, cb.shape[0], HW, *strides,
            vq.rows_per_thread(B * HW, sms), torch.cuda.current_stream().cuda_stream),
            "vq_parts")
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("vq_parts: CUDA is not available; this tool runs on a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    with open(SOURCE) as f:
        source = f.read()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(lambda n: build(n, source), VARIANTS)))
    runs = {name: runner(lib) for name, lib in libs.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cb = torch.randn(256, 4, generator=gen, device=dev) * 0.05
    for label, B, h, w in VQ_SHAPES:
        z = torch.randn(B, 4, h, w, generator=gen, device=dev) * 0.05
        if not torch.equal(runs["kernel"](z, cb), vq.vq_argmin_nchw(z, cb).reshape(-1)):
            raise AssertionError(f"the kernel as built here differs from the port's, {label}")
        us = {name: profiled_ms(run, z, cb, kernel="vq_argmin") * 1e3
              for name, run in runs.items()}
        names = list(us)
        parts = ", ".join(f"{a} - {b} = {us[a] - us[b]:.3f}" for a, b in zip(names, names[1:]))
        print(f"M={B * h * w} ({label}), bound {bound_ms(B * h * w)[0] * 1e3:.3f} us: "
              + ", ".join(f"{n} {t:.3f} us" for n, t in us.items()) + f"; parts: {parts}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
