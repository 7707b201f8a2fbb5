"""Device time of the attention kernel K2 at the shapes its callers give it,
on one GPU.

    python -m dc_vic_tpu_torch.tools.attn_time [--parent DIR] [--out FILE]

For each shape of ``ATTN_SHAPES`` (the [4, 6144, 512] of ``PERF.md``'s kernel
table, the contract's batch 16 of 768x512, training's batch 6 of 256x256) it
times ``flash_attention`` on f32 operands with q pre-scaled by C^-1/2, by the
replay of a CUDA graph (``utils/profiling.py::graph_ms``) and by the kernel's
own duration under ``torch.profiler`` (``profiled_ms``). Beside it, by graph
replay: the plain version ``attention_plain`` (two f32 ``bmm``s and a
softmax) and one ``F.scaled_dot_product_attention`` call; neither is on the
port's path. The bound is the larger of the bytes (q, k, v read once, the
output written once) over 3.35 TB/s and the two products' 4 B N^2 C
operations, taken as three TF32 products each, over 495 TFLOP/s (data
sheet).

``--parent DIR`` names the ``dc_vic_tpu_torch`` directory of another tree
(``git archive <commit> dc_vic_tpu_torch`` unpacked into a directory that
``.gitignore`` lists): its ``ops/attention.py`` is loaded under a private
name with its own native library, built from its own sources
(``utils/profiling.py::load_parent``), and both are timed in turns (parent,
this tree, this tree, parent), each figure the mean of its two turns. The
largest difference between the two outputs is printed. Needs CUDA; fails
without.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import attention
from ..utils.profiling import graph_ms, load_parent, profiled_ms

# (label, [B, N, C], calls captured in a graph: about 0.1-0.2 s of kernel time)
ATTN_SHAPES = (("PERF.md's kernel table, batch 4 of 768x512", (4, 6144, 512), 20),
               ("contract, batch 16 of 768x512", (16, 6144, 512), 5),
               ("training, batch 6 of 256x256", (6, 1024, 512), 100))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
TF32_FLOPS_PER_S = 495e12     # H100 SXM data sheet, dense TF32 on the tensor cores


def bound_ms(B: int, N: int, C: int):
    """(ms, what binds) of K2 on [B, N, C] f32 operands."""
    by_bytes = 4 * B * N * C * 4 / HBM_BYTES_PER_S * 1e3
    by_ops = 3 * 4 * B * N * N * C / TF32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_impl(mod, q, k, v, launches):
    return {"graph_ms": graph_ms(mod.flash_attention, q, k, v, launches=launches, replays=3),
            "profiled_ms": profiled_ms(mod.flash_attention, q, k, v, kernel="flash_attn_f32",
                                       launches=launches)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="dc_vic_tpu_torch directory of the tree to time in turns")
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_time: CUDA is not available; this tool runs on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    impls = [("change", attention)]
    if args.parent:
        impls = [("parent", load_parent(args.parent, "attention", "_attn_time_parent_ops")),
                 ("change", attention)]
    order = impls + impls[::-1]                   # parent, change, change, parent
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for label, (B, N, C), launches in ATTN_SHAPES:
        q = torch.randn(B, N, C, generator=gen, device=dev) * C ** -0.5
        k, v = (torch.randn(B, N, C, generator=gen, device=dev) for _ in range(2))
        runs = {name: [] for name, _ in impls}
        for name, mod in order:
            runs[name].append(time_impl(mod, q, k, v, launches))
        ms, by = bound_ms(B, N, C)
        row = {"shape": label, "B": B, "N": N, "C": C, "bound_ms": ms, "bound_by": by,
               "plain_graph_ms": graph_ms(attention.attention_plain, q, k, v,
                                          launches=launches, replays=3),
               "sdpa_graph_ms": graph_ms(
                   lambda a, b, c: F.scaled_dot_product_attention(a, b, c, scale=1.0),
                   q, k, v, launches=launches, replays=3)}
        if args.parent:
            row["parent_change_max_abs_diff"] = float(
                (impls[0][1].flash_attention(q, k, v) - attention.flash_attention(q, k, v))
                .abs().max())
        for name, turns in runs.items():
            row[name] = {key: sum(t[key] for t in turns) / len(turns) for key in turns[0]}
            row[name]["turns"] = turns
        rows.append(row)
        print(f"[{B},{N},{C}] ({label}): bound {ms:.4f} ms ({by}), plain "
              f"{row['plain_graph_ms']:.4f} ms, F.scaled_dot_product_attention "
              f"{row['sdpa_graph_ms']:.4f} ms (graph)"
              + (f"; parent and change {row['parent_change_max_abs_diff']:.3e} apart"
                 if args.parent else ""))
        for name, _ in impls:
            r = row[name]
            turns = ", ".join(f"{t['profiled_ms']:.4f}" for t in r["turns"])
            print(f"  {name}: {r['graph_ms']:.4f} ms graph, {r['profiled_ms']:.4f} ms profiler "
                  f"(turns {turns}); bound share {ms / r['profiled_ms']:.1%}")
        del q, k, v
        torch.cuda.empty_cache()
    result = {"device": smi, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
