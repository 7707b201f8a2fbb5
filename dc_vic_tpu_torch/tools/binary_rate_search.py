"""Binary search for the beta_rate values that hit target bitrates (port of
``scripts/binary_rate_search.py``; writes
``binary_rate_search_results.json``).

    python3 -m dc_vic_tpu_torch.tools.binary_rate_search --config_path \\
        config/dc_vic_patchgan.yaml --val_dir val/images --save_dir out/ \\
        [--vq_indices_dir val/vq_indices] [--model_path ckpt.pth.tar] \\
        [--target_rates 0.05 0.075 ...] [--beta_vq_list 1.0 1.5 ...] [--device cuda]

For each (beta_vq, target rate): bisect beta_rate in [0, max_beta_rate]
(at most MAX_ITERS probes, memoized per beta_vq, TOL bpp) on the estimated
(quantized-likelihood) bpp over the pre-cropped validation set. With
``--vq_indices_dir`` the precomputed token maps stand in for the frozen
VQGAN encode. Pillow is needed only to read the crops: ``make_avg_bpp`` and
``search`` are the whole computation over images in memory.
"""
from __future__ import annotations

import argparse
import json
import os
from glob import glob
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.dc_vic import likelihood_to_bpp
from .calc_metrics import to_pm1
from .compress import build_model, load_image

TOL = 0.001
MAX_ITERS = 10


def bisect_beta_rate(avg_bpp_fn, target: float, max_beta_rate: float,
                     memo: dict, tol: float = TOL,
                     max_iters: int = MAX_ITERS):
    """Memoized bisection of beta_rate in [0, max_beta_rate] for an
    avg_bpp_fn that is monotone DECREASING in beta_rate (the rate
    condition: larger beta_rate -> lower bpp). Returns the best
    (beta_rate, bpp) pair seen, the one closest to the target; stops early
    within ``tol``. ``memo`` (keyed on the rounded beta_rate) is shared
    across one beta_vq's targets, so a repeated probe reuses its value."""
    lo, hi = 0.0, max_beta_rate
    best = None
    for _ in range(max_iters):
        mid = (lo + hi) / 2.0
        key = round(mid, 6)
        if key not in memo:
            memo[key] = avg_bpp_fn(mid)
        bpp = memo[key]
        if best is None or abs(bpp - target) < abs(best[1] - target):
            best = (mid, bpp)
        if abs(bpp - target) <= tol:
            break
        if bpp > target:
            lo = mid
        else:
            hi = mid
    return best


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--val_dir", type=str, required=True,
                   help="directory of pre-cropped validation images")
    p.add_argument("--vq_indices_dir", type=str, default=None,
                   help="directory of precomputed VQGAN token maps (<name>.npy, from "
                        "build_val_dataset.py); skips the frozen VQGAN encode")
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--target_rates", type=float, nargs="+",
                   default=[0.05, 0.075, 0.1, 0.125, 0.15])
    p.add_argument("--beta_vq_list", type=float, nargs="+",
                   default=[1.0, 1.5, 2.0, 2.5, 3.0, 3.5])
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_images", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the model (default cuda; cpu runs without a card)")
    return p.parse_args(argv)


def make_avg_bpp(module, imgs: np.ndarray, batch_size: int = 8,
                 idx_maps: Optional[np.ndarray] = None) -> Callable[[float, float], float]:
    """avg_bpp(beta_rate, beta_vq): the estimated bpp of ``imgs`` (float32
    [N, H, W, 3] in [-1, 1]), image-weighted over the full set (the
    remainder batch runs at its own shape). With ``idx_maps`` ([N, H/8,
    W/8] token maps) the quantized latent is the codebook lookup of the
    map, and the frozen VQGAN encoder never runs; without, the model's eval
    forward gives ``qbpp``."""
    dev = next(module.parameters()).device

    @torch.no_grad()
    def qbpp(x, idx, b1, b2):
        if idx is None:
            return module(x, b1, b2, is_train=False)["qbpp"]
        lat = module.vq_indices_to_latent(idx)
        y = module.comp_encode(x, lat, idx, b1, b2)
        ent = module.estimate_entropy(y, is_train=False)
        num_pixel = x.shape[0] * x.shape[2] * x.shape[3]
        return (likelihood_to_bpp(ent["q_likelihoods"]["y"], num_pixel)
                + likelihood_to_bpp(ent["q_likelihoods"]["z"], num_pixel))

    def avg_bpp(beta_rate: float, beta_vq: float) -> float:
        b1 = torch.tensor([beta_rate], dtype=torch.float32, device=dev)
        b2 = torch.tensor([beta_vq], dtype=torch.float32, device=dev)
        total, n = 0.0, 0
        for i in range(0, len(imgs), batch_size):
            batch = torch.from_numpy(imgs[i:i + batch_size]).to(dev)
            batch = batch.permute(0, 3, 1, 2).contiguous()
            idx = (None if idx_maps is None else
                   torch.from_numpy(idx_maps[i:i + batch_size].astype(np.int32)).to(dev))
            total += float(qbpp(batch, idx, b1, b2)) * batch.shape[0]
            n += batch.shape[0]
        return total / n
    return avg_bpp


def search(avg_bpp: Callable[[float, float], float], beta_vq_list: Sequence[float],
           target_rates: Sequence[float], max_beta_rate: float) -> List[Dict]:
    """One bisection per (beta_vq, target), a memo per beta_vq. Returns the
    rows of ``binary_rate_search_results.json``."""
    results = []
    for beta_vq in beta_vq_list:
        memo = {}
        for target in target_rates:
            beta_rate, bpp = bisect_beta_rate(lambda br: avg_bpp(br, beta_vq), target,
                                              max_beta_rate, memo)
            results.append(dict(beta_vq=beta_vq, target_rate=target, beta_rate=beta_rate,
                                achieved_bpp=bpp))
            print(f"beta_vq={beta_vq} target={target}: beta_rate={beta_rate:.4f} "
                  f"bpp={bpp:.5f}")
    return results


def val_paths(val_dir: str, max_images: int) -> List[str]:
    paths = sorted(glob(os.path.join(val_dir, "*.png"))
                   + glob(os.path.join(val_dir, "*.jpg")))[:max_images]
    if not paths:
        raise SystemExit(f"no images in {val_dir}")
    return paths


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.save_dir, exist_ok=True)
    spec = build_model(args.config_path, args.model_path, args.device)
    paths = val_paths(args.val_dir, args.max_images)
    imgs = np.stack([to_pm1(load_image(p)) for p in paths])
    idx_maps = None
    if args.vq_indices_dir:
        idx_maps = np.stack([np.load(os.path.join(
            args.vq_indices_dir, os.path.splitext(os.path.basename(p))[0] + ".npy"))
            for p in paths])
    results = search(make_avg_bpp(spec.module, imgs, args.batch_size, idx_maps),
                     args.beta_vq_list, args.target_rates, spec.max_beta_rate)
    out = os.path.join(args.save_dir, "binary_rate_search_results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
