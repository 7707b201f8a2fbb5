"""Offline evaluation: PSNR, MS-SSIM, FID (HiFiC 256-patch protocol), LPIPS
and DISTS of a folder of reconstructions (port of ``scripts/calc_metrics.py``;
writes ``_metrics.json`` beside the reconstructions).

    python3 -m dc_vic_tpu_torch.tools.calc_metrics --real_dir photos/ --fake_dir out/ \\
        [--lpips_weights alex.pth] [--dists_weights dists.pth] \\
        [--inception_weights pt_inception.pth] [--device cuda]

The perceptual networks' weights are optional inputs (not in the
repository); a metric without them reports null and is listed in
``skipped``. Pillow is needed only to read the PNGs: ``calc_metrics_arrays``
is the whole computation over images in memory.
"""
from __future__ import annotations

import argparse
import json
import os
from glob import glob
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..metrics.feature_nets import load_dists, load_lpips
from ..metrics.fid import MIN_IMAGES, compute_fid
from ..metrics.image import calc_ms_ssim, calc_psnr
from ..metrics.inception import load_inception
from .compress import load_image


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--real_dir", type=str, required=True)
    p.add_argument("--fake_dir", type=str, required=True,
                   help="reconstructions (+ _avg_bitrate.json) directory")
    p.add_argument("--lpips_weights", type=str, default=None)
    p.add_argument("--lpips_net", type=str, default="alex")
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--dists_weights", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the networks (default cuda; cpu runs without a card)")
    return p.parse_args(argv)


def to_pm1(u8: np.ndarray) -> np.ndarray:
    """uint8 images -> float32 in [-1, 1], the reference's conversion."""
    return (u8.astype(np.float32) / 255.0 - 0.5) * 2.0


def _nchw(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).to(device)


def _device(net: torch.nn.Module):
    return next(net.parameters()).device


@torch.no_grad()
def calc_metrics_arrays(reals: Sequence[np.ndarray], fakes: Sequence[np.ndarray],
                        lpips: Optional[torch.nn.Module] = None,
                        dists: Optional[torch.nn.Module] = None,
                        inception: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                        bitrate: Optional[float] = None) -> dict:
    """The metrics of uint8 [H, W, 3] image pairs, each pair of one shape:
    PSNR and MS-SSIM per image, averaged; LPIPS (``load_lpips``'s module,
    inputs in [-1, 1]) and DISTS (``load_dists``'s, inputs in [0, 1]) per
    image on the networks' device, averaged; FID over the HiFiC patches
    with ``inception`` (``metrics/inception.py::load_inception``'s
    function) from MIN_IMAGES pairs on. A network given as None skips its
    metric. Returns the dict ``_metrics.json`` holds."""
    if len(reals) != len(fakes) or not reals:
        raise ValueError(f"{len(reals)} real and {len(fakes)} fake images")
    for i, (r, f) in enumerate(zip(reals, fakes)):
        if r.shape != f.shape:
            raise ValueError(f"pair {i}: {r.shape} != {f.shape}")
    psnrs, msssims = [], []
    for r, f in zip(reals, fakes):
        rr, ff = to_pm1(r)[None], to_pm1(f)[None]
        psnrs.append(calc_psnr(rr, ff))
        msssims.append(calc_ms_ssim(rr.transpose(0, 3, 1, 2), ff.transpose(0, 3, 1, 2)))
    msssim_vals = [s for s in msssims if s >= 0]

    skipped: List[str] = []
    lpips_val = dists_val = fid_val = None
    if lpips is None:
        skipped.append("lpips (no weights: pass --lpips_weights)")
    else:
        dev = _device(lpips)
        lpips_val = float(np.mean([
            float(torch.mean(lpips(_nchw(to_pm1(r)[None], dev), _nchw(to_pm1(f)[None], dev))))
            for r, f in zip(reals, fakes)]))
    if dists is None:
        skipped.append("dists (no weights: pass --dists_weights)")
    else:
        dev = _device(dists)
        unit = lambda u8: _nchw(u8[None].astype(np.float32) / 255.0, dev)
        dists_val = float(np.mean([float(torch.mean(dists(unit(r), unit(f))))
                                   for r, f in zip(reals, fakes)]))
    if inception is None:
        skipped.append("fid (no weights: pass --inception_weights)")
    elif len(reals) < MIN_IMAGES:
        skipped.append(f"fid (needs >= {MIN_IMAGES} images, got {len(reals)})")
    else:
        fid_val = compute_fid(list(reals), list(fakes), inception)
    return {
        "bitrate": bitrate,
        "psnr": float(np.mean(psnrs)),
        "ms_ssim": float(np.mean(msssim_vals)) if msssim_vals else None,
        "fid": fid_val,
        "lpips": lpips_val,
        "dists": dists_val,
        "num_images": len(reals),
        "skipped": skipped,
    }


def main(argv=None):
    args = parse_args(argv)
    pairs = []
    for fp in sorted(glob(os.path.join(args.fake_dir, "*.png"))):
        rp = os.path.join(args.real_dir, os.path.basename(fp))
        if os.path.exists(rp):
            pairs.append((rp, fp))
    if not pairs:
        raise SystemExit("no matching real/fake image pairs")
    print(f"{len(pairs)} image pairs")
    bitrate = None
    avg_json = os.path.join(args.fake_dir, "_avg_bitrate.json")
    if os.path.exists(avg_json):
        with open(avg_json) as f:
            bitrate = json.load(f).get("avg_bpp")
    out = calc_metrics_arrays(
        [load_image(rp) for rp, _ in pairs], [load_image(fp) for _, fp in pairs],
        lpips=load_lpips(args.lpips_weights, args.lpips_net, args.device),
        dists=load_dists(args.dists_weights, args.device),
        inception=(load_inception(args.inception_weights, args.device)
                   if args.inception_weights else None),
        bitrate=bitrate)
    with open(os.path.join(args.fake_dir, "_metrics.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
