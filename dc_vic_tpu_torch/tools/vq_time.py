"""Device time of the nearest-codeword kernel K1 at the shapes its callers
give it, apart from its Python wrapper, on one GPU.

    python -m dc_vic_tpu_torch.tools.vq_time [--parent DIR] [--out FILE]

For each latent of ``VQ_SHAPES`` (training's batch 6 of 256x256, batch 4 of
768x512, the tiled 2048x1365 canvas, the contract's batch 16 of 768x512) it
times, with a [256, 4] codebook:

* ``flat``: the flat entry ``vq_argmin(z_flat [M, 4], codebook)``;
* ``caller``: what ``models/vqgan.py::VectorQuantizer.forward`` launches for
  the [B, 4, H, W] latent: ``vq_argmin_nchw(z, codebook)`` where the module
  has it, else the permute copy to rows and the flat entry.

Each by three methods (``utils/profiling.py``): the replay of a CUDA graph
of 100 calls (``graph_ms``), the kernel's own duration under
``torch.profiler`` (``profiled_ms``) and the host's microseconds a call
(``host_us_per_call``, 1,000 calls). An empty kernel (``csrc/launch_floor.cu``)
is timed by the first two, as the floor a one-launch kernel cannot go under,
and the plain version by graph replay. The bound is the larger of the bytes
(z and the codebook read once, the indices written once) over 3.35 TB/s and
10 operations a (row, codeword) pair (the four multiply-adds of the cross
term and the norm's share) over 67 TFLOP/s f32 (data sheet).

``--parent DIR`` names the ``dc_vic_tpu_torch`` directory of another tree
(``git archive <commit> dc_vic_tpu_torch`` unpacked into a directory that
``.gitignore`` lists): its ``ops/vq.py`` is loaded under a private name with
its own native library, built from its own sources, and both are timed in
turns (parent, this tree, this tree, parent), each figure the mean of its
two turns. Needs CUDA; fails without.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from ..codec.driver import STRIDE, VQ_STRIDE
from ..ops import native, vq
from ..utils.profiling import graph_ms, host_us_per_call, load_parent, profiled_ms


def latent_hw(H: int, W: int):
    """The VQGAN latent's (h, w) of an H x W image, padded as the codec pads."""
    return (-(-H // STRIDE) * STRIDE // VQ_STRIDE, -(-W // STRIDE) * STRIDE // VQ_STRIDE)


# (label, B, h, w) of the latents K1 quantizes on the port's paths
VQ_SHAPES = (("training, batch 6 of 256x256", 6, *latent_hw(256, 256)),
             ("batch 4 of 768x512", 4, *latent_hw(768, 512)),
             ("tiled 2048x1365 canvas", 1, *latent_hw(2048, 1365)),
             ("contract, batch 16 of 768x512", 16, *latent_hw(768, 512)))
N_EMBED = 256
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, f32 outside the tensor cores
OPS_PER_PAIR = 10


def bound_ms(M: int, N: int = N_EMBED, D: int = 4):
    """(ms, what binds) of K1 on M rows against N codewords."""
    by_bytes = (M * D * 4 + N * D * 4 + M * 4) / HBM_BYTES_PER_S * 1e3
    by_ops = M * N * OPS_PER_PAIR / F32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def caller(mod):
    """The K1 call of ``VectorQuantizer.forward`` in the tree of ``mod``."""
    if hasattr(mod, "vq_argmin_nchw"):
        return mod.vq_argmin_nchw

    def rows(z, cb):
        return mod.vq_argmin(z.permute(0, 2, 3, 1).reshape(-1, z.shape[1]), cb)
    return rows


def time_impl(mod, z, cb):
    flat = z.permute(0, 2, 3, 1).reshape(-1, z.shape[1]).contiguous()
    call = caller(mod)
    return {"flat_graph_ms": graph_ms(mod.vq_argmin, flat, cb),
            "flat_profiled_ms": profiled_ms(mod.vq_argmin, flat, cb, kernel="vq_argmin"),
            "flat_host_us_per_call": host_us_per_call(mod.vq_argmin, flat, cb),
            "caller_graph_ms": graph_ms(call, z, cb),
            "caller_profiled_ms": profiled_ms(call, z, cb, kernel="vq_argmin"),
            "caller_host_us_per_call": host_us_per_call(call, z, cb)}


def launch_floor():
    """(graph ms, profiled ms) of an empty one-block kernel."""
    lib = native.kernels()

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        native.check(lib.dcvic_launch_floor(1, 32, stream), "launch_floor")
    return graph_ms(launch), profiled_ms(launch, kernel="launch_floor_kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="dc_vic_tpu_torch directory of the tree to time in turns")
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("vq_time: CUDA is not available; this tool runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    impls = [("change", vq)]
    if args.parent:
        impls = [("parent", load_parent(args.parent, "vq", "_vq_time_parent_ops")),
                 ("change", vq)]
    order = impls + impls[::-1]                   # parent, change, change, parent
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cb = torch.randn(N_EMBED, 4, generator=gen, device=dev) * 0.05
    floor_graph, floor_prof = launch_floor()
    print(f"empty kernel: graph replay {floor_graph:.5f} ms, profiler {floor_prof:.5f} ms")
    rows = []
    for label, B, h, w in VQ_SHAPES:
        z = torch.randn(B, 4, h, w, generator=gen, device=dev) * 0.05
        M = B * h * w
        runs = {name: [] for name, _ in impls}
        for name, mod in order:
            runs[name].append(time_impl(mod, z, cb))
        ms, by = bound_ms(M)
        row = {"shape": label, "B": B, "h": h, "w": w, "M": M, "bound_ms": ms, "bound_by": by,
               "plain_graph_ms": graph_ms(vq.vq_argmin_plain,
                                          z.permute(0, 2, 3, 1).reshape(M, 4), cb)}
        for name, turns in runs.items():
            row[name] = {k: sum(t[k] for t in turns) / len(turns) for k in turns[0]}
            row[name]["turns"] = turns
        rows.append(row)
        print(f"M={M} ({label}): bound {ms * 1e3:.3f} us ({by}), plain "
              f"{row['plain_graph_ms'] * 1e3:.3f} us (graph)")
        for name, _ in impls:
            r = row[name]
            print(f"  {name}: flat entry {r['flat_graph_ms'] * 1e3:.3f} us graph, "
                  f"{r['flat_profiled_ms'] * 1e3:.3f} us profiler, "
                  f"{r['flat_host_us_per_call']:.2f} us host a call; caller "
                  f"{r['caller_graph_ms'] * 1e3:.3f} us graph, "
                  f"{r['caller_profiled_ms'] * 1e3:.3f} us profiler (K1 alone), "
                  f"{r['caller_host_us_per_call']:.2f} us host; "
                  f"bound share {ms / r['caller_profiled_ms']:.1%} (profiler)")
    result = {"device": smi, "launch_floor_graph_ms": floor_graph,
              "launch_floor_profiled_ms": floor_prof, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
