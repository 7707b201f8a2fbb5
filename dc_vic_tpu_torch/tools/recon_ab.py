"""The flagship codec's round trip with the reconstruction kernels off and
on, on one GPU: end-to-end times in turns, and where the device time goes.

    python -m dc_vic_tpu_torch.tools.recon_ab [--runs 6] [--out FILE]
        [--stream-format compressai|tpu] [--encode-backend host|device] [--lanes 128]
        [--codec-dtype float32|bfloat16] [--batch 4]
        [--recon-kernels gn,conv3x3,fused_resblock] [--deployment]

Two models with the same seed-0 weights (config/dc_vic_patchgan.yaml, full
width and depth; f32, or with ``--codec-dtype bfloat16`` the deployment
numerics: bf16 conv stacks and ``entropy_precision: default``): the default
one, and one built with
recon_kernels = gn, conv3x3, fused_resblock. After one warm-up round trip
each, a batch of ``--batch`` 768x512 noise images goes through Codec.compress and
Codec.decompress ``--runs`` times per model in the order off, on, on, off,
...; every time is printed (host clock around a call that ends in
torch.cuda.synchronize()), then the medians. Then one round trip of each
model runs under torch.profiler (CPU and CUDA activities) and the device
time is summed by the program span that launched it (``utils/profiling.py::
span_times``: the codec's stages, the model's, the NN modules'), by kernel
name and by group:

* conv and matmul library: cuDNN and cuBLAS kernels with their FFT and
  layout-transpose helpers;
* the port's kernels, one line each;
* elementwise and reductions: PyTorch's own pointwise and reduce kernels
  (GroupNorm statistics and affine, FiLM, SFT, residual adds, activations);
* other: copies, index kernels and what no pattern matched.

``--stream-format`` picks the format both models write (default
compressai, the format of the earlier breakdowns); with ``tpu`` the coder
kernels R1 and R2 appear among the port's kernels, and ``--encode-backend``
and ``--lanes`` are the Codec's arguments of those names.
``--recon-kernels`` names the kernels of the "on" model (``gn`` alone keeps
the convolutions with cuDNN). ``--deployment`` takes the deployment workload
of ``tools/workload.py`` instead: bf16 and ``default``, tpu format, device
backend, 512 lanes, sixteen smooth images, encoder weights scaled.

The grouping is by substrings of the kernel names and is printed in full
(top kernels by time), so a wrong guess shows. Needs CUDA; fails without.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..codec.driver import Codec
from ..models import RECON_KERNELS, build_comp_model, init_weights
from ..utils.config import load_config
from ..utils.profiling import kernel_report, kernel_times, span_times
from .workload import DEPLOYMENT, deployment_images, scale_encoder

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the bf16 conv kernel is one template: <false> is K5, <true> K6
OWN = ("vq_argmin_kernel", "flash_attn_f32_kernel", "gn_channel_sums_kernel",
       "gn_apply_kernel", "gn_fold_kernel", "conv3x3_same_kernel", "conv3x3_gn_swish_kernel",
       "conv3x3_bf16_kernel<false>", "conv3x3_bf16_kernel<true>", "repack_weights_kernel",
       "repack_weights_bf16_kernel", "rans_encode_symbols_kernel", "rans_encode_states_kernel",
       "rans_encode_scan_kernel", "rans_encode_scatter_kernel", "rans_decode_section_kernel")
LIBRARY = ("cudnn", "cutlass", "gemm", "gemv", "fft", "DSE::", "region_transform", "conv",
           "nchwToNhwc", "nhwcToNchw", "implicit", "xmma", "dgrad", "sm90_", "sm80_")
POINTWISE = ("elementwise", "reduce", "Reduce", "vectorized", "softmax", "layer_norm",
             "LayerNorm", "CatArray", "upsample", "Upsample")


def group_of(name: str) -> str:
    for own in OWN:
        if own in name:
            return own
    if any(p in name for p in LIBRARY):
        return "conv and matmul library"
    if any(p in name for p in POINTWISE):
        return "elementwise and reductions"
    return "other"


def round_trip(codec: Codec, images: np.ndarray):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = codec.compress(images, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    codec.decompress([r["string_list"] for r in res])
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1, float(np.mean([r["bpp"] for r in res]))


def device_times(codec: Codec, images: np.ndarray):
    """{kernel name: (device microseconds, calls)} of one round trip, the
    same by program span, and the wall seconds it took under the
    profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = sum(round_trip(codec, images)[:2])
    return kernel_times(prof), span_times(prof), wall


def report(label: str, times: dict, spans: dict, wall: float, emit) -> None:
    total = sum(us for us, _ in times.values())
    if total <= 0:
        raise RuntimeError("the profiler recorded no device time")
    emit(f"--- {label}: device time {total / 1e3} ms in {sum(n for _, n in times.values())} "
         f"kernel launches; wall {wall} s under the profiler")
    emit("by program span (innermost):")
    for line in kernel_report(spans, top=40)[1:]:
        emit(line)
    groups = {}
    for name, (us, n) in times.items():
        g = groups.setdefault(group_of(name), [0.0, 0])
        g[0] += us
        g[1] += n
    for g, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        emit(f"{100 * us / total:6.2f}%  {us / 1e3:10.3f} ms  {n:6d} launches  {g}")
    emit("top kernels:")
    for name, (us, n) in sorted(times.items(), key=lambda kv: -kv[1][0])[:30]:
        emit(f"{100 * us / total:6.2f}%  {us / 1e3:10.3f} ms  {n:6d}  [{group_of(name)}]  "
             f"{name[:110]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=6, help="timed round trips per model")
    ap.add_argument("--out", default=None, help="also write the report to this file")
    ap.add_argument("--stream-format", default="compressai", choices=("compressai", "tpu"))
    ap.add_argument("--encode-backend", default="device", choices=("host", "device"),
                    help="where tpu-format streams are entropy-coded")
    ap.add_argument("--lanes", type=int, default=128, help="lane cap of tpu-format streams")
    ap.add_argument("--codec-dtype", default="float32", choices=("float32", "bfloat16"),
                    help="bfloat16: bf16 conv stacks and entropy_precision 'default'")
    ap.add_argument("--batch", type=int, default=4, help="images per round trip")
    ap.add_argument("--recon-kernels", default=",".join(RECON_KERNELS),
                    help="comma-separated recon_kernels of the 'on' model")
    ap.add_argument("--deployment", action="store_true",
                    help="the deployment workload: sets the five options above")
    args = ap.parse_args()
    if args.deployment:
        args.stream_format, args.encode_backend, args.codec_dtype = "tpu", "device", "bfloat16"
        args.lanes, args.batch = DEPLOYMENT["lanes"], DEPLOYMENT["batch"]
    names = tuple(n for n in args.recon_kernels.split(",") if n)
    if not torch.cuda.is_available():
        raise SystemExit("recon_ab: CUDA is not available; this script runs on a GPU")
    lines = []

    def emit(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    emit("nvidia-smi: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    emit(f"torch {torch.__version__} cuda {torch.version.cuda}")
    opt = load_config(os.path.join(ROOT, "config", "dc_vic_patchgan.yaml"))
    if args.codec_dtype == "bfloat16":
        opt["codec_dtype"], opt["entropy_precision"] = "bfloat16", "default"
    emit(f"model: codec_dtype {opt.get('codec_dtype')}, entropy_precision "
         f"{opt.get('entropy_precision', 'high')}, batch {args.batch}")
    off = build_comp_model(opt)
    if args.deployment:         # scale the f32 draw, then round: as a loaded checkpoint
        f32 = build_comp_model(load_config(os.path.join(ROOT, "config", "dc_vic_patchgan.yaml")))
        init_weights(f32.module, torch.Generator(device="cuda").manual_seed(0))
        off.module.load_state_dict(scale_encoder(f32.module.state_dict()), strict=True)
        del f32
    else:
        init_weights(off.module, torch.Generator(device="cuda").manual_seed(0))
    on = build_comp_model(opt, recon_kernels=names)
    on.module.load_state_dict(off.module.state_dict(), strict=True)
    kw = dict(stream_format=args.stream_format, encode_backend=args.encode_backend,
              lanes=args.lanes)
    emit(f"codec: {kw}; recon_kernels of 'on': {names}; deployment workload: "
         f"{args.deployment}")
    codecs = {"off": Codec(off, **kw), "on": Codec(on, **kw)}
    images = (deployment_images() if args.deployment else
              np.random.default_rng(0).integers(0, 256, (args.batch, 768, 512, 3),
                                                dtype=np.uint8))
    for name, codec in codecs.items():
        enc, dec, bpp = round_trip(codec, images)
        emit(f"warm-up, kernels {name}: encode {enc} s, decode {dec} s, {bpp} bpp")
    seen = {"off": [], "on": []}
    for i in range(args.runs):
        for name in (("off", "on") if i % 2 == 0 else ("on", "off")):
            seen[name].append(round_trip(codecs[name], images))
    for name, runs in seen.items():
        emit(f"kernels {name}: encode s {[r[0] for r in runs]}")
        emit(f"kernels {name}: decode s {[r[1] for r in runs]}")
        emit(f"kernels {name}: median encode {statistics.median(r[0] for r in runs)} s, "
             f"median decode {statistics.median(r[1] for r in runs)} s over {len(runs)} runs")
    for name, codec in codecs.items():
        times, spans, wall = device_times(codec, images)
        report(f"reconstruction kernels {name}", times, spans, wall, emit)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    sys.exit(main())
