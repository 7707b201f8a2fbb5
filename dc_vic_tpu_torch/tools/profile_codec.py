"""Per-stage codec profiler (port of scripts/profile_codec.py): the host
clock of each stage of the compress -> decompress cycle, and with
``--trace_dir`` a ``torch.profiler`` trace of the timed rounds and the
device time per kernel name and per program span.

    python3 -m dc_vic_tpu_torch.tools.profile_codec --config_path config/dc_vic_patchgan.yaml \\
        [--model_path ckpt.pth.tar] [--batch 8] [--height 768] [--width 512] [--rounds 3] \\
        [--trace_dir DIR] [--stream_format tpu|compressai] [--device cuda]

The stages, each ended by a wait for the device work it queued:

  1_device_encode+sym_d2h       ``Codec.compress_dispatch``: the encode front,
                                the entropy chain and (device backend) R1
  2_host_rans_encode            ``Codec.compress_finalize``: the streams to the
                                host, or the symbols and the host coder
  3_decode_z+hyper+charm+recon  ``Codec.decompress(defer_fetch=True)``: the
                                decode chain (R2 in the tpu format) and the
                                reconstruction
  4_image_d2h                   ``PendingImages.fetch``: the pixels to the host

The images are uint8 noise from seed 0; the model is ``tools/compress.py::
build_model``'s (the checkpoint's weights, or seed 0's). One warm-up cycle
runs first.
"""
from __future__ import annotations

import argparse
import contextlib

import numpy as np

from ..codec.driver import Codec, PendingImages
from ..utils.logger import get_root_logger
from ..utils.profiling import (StageTimer, device_trace, kernel_report, kernel_times,
                               span_times)

STAGES = ("1_device_encode+sym_d2h", "2_host_rans_encode", "3_decode_z+hyper+charm+recon",
          "4_image_d2h")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--trace_dir", type=str, default=None)
    p.add_argument("--stream_format", type=str, default="tpu", choices=["tpu", "compressai"])
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the model (default cuda; cpu runs without a card)")
    return p.parse_args(argv)


def _cycle(codec: Codec, images: np.ndarray, timer: StageTimer, betas) -> None:
    dev = codec.device
    with timer.stage(STAGES[0], dev):
        handle = codec.compress_dispatch(images, **betas)
    with timer.stage(STAGES[1], dev):
        res = codec.compress_finalize(handle)
    strings = [r["string_list"] for r in res]
    with timer.stage(STAGES[2], dev):
        pending = codec.decompress(strings, defer_fetch=True)
    with timer.stage(STAGES[3], dev):
        if isinstance(pending, PendingImages):      # the compressai format decodes on the host
            pending.fetch()


def profile(codec: Codec, images: np.ndarray, rounds: int, trace_dir=None, **betas):
    """``rounds`` timed cycles of ``images`` ([B, H, W, 3] uint8) through
    ``codec`` at ``betas`` (``quality_ind``, or ``beta_rate`` and
    ``beta_vq``) after one warm-up cycle: the ``StageTimer`` report, one
    entry per stage of ``STAGES``. With ``trace_dir`` the timed rounds are
    traced there and the device time per kernel (top 20 and the total) and
    per program span is printed."""
    _cycle(codec, images, StageTimer(), betas)
    timer = StageTimer()
    with device_trace(trace_dir) if trace_dir else contextlib.nullcontext() as prof:
        for _ in range(rounds):
            _cycle(codec, images, timer, betas)
    if trace_dir:
        for line in kernel_report(kernel_times(prof)):
            print(line)
        print("by program span (innermost):")
        for line in kernel_report(span_times(prof), top=40):
            print(line)
    return timer.report()


def main(argv=None):
    from .compress import build_model
    args = parse_args(argv)
    logger = get_root_logger()
    spec = build_model(args.config_path, args.model_path, args.device)
    codec = Codec(spec, stream_format=args.stream_format)
    B, H, W = args.batch, args.height, args.width
    images = np.random.default_rng(0).integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    betas = ({"quality_ind": 0} if spec.selected_beta_rate
             else {"beta_rate": 1.0, "beta_vq": 1.0})
    report = profile(codec, images, args.rounds, args.trace_dir, **betas)
    for k, v in report.items():
        logger.info(f"[stage] {k}: {v['mean_sec'] * 1000:.1f} ms/call "
                    f"x{v['count']} ({v['total_sec']:.2f}s total)")
    total = sum(v["mean_sec"] for v in report.values())
    logger.info(f"end-to-end: {total:.3f}s / batch -> {B / total:.2f} img/s")
    return report


if __name__ == "__main__":
    main()
