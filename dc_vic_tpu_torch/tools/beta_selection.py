"""Select a (beta_rate, beta_vq) pair per target rate by reconstruction
quality, score = ALPHA * PSNR - FID with ALPHA = 2 (port of
``scripts/beta_selection.py``; writes ``beta_selection_results.csv``).

    python3 -m dc_vic_tpu_torch.tools.beta_selection --config_path \\
        config/dc_vic_patchgan.yaml --val_dir val/images \\
        --search_results out/binary_rate_search_results.json --save_dir out/ \\
        [--inception_weights pt_inception.pth] [--model_path ckpt.pth.tar] [--device cuda]

For each candidate of the rate search's results the validation set is
reconstructed at its pair and scored; the best candidate of each target
rate is ``selected``. Without InceptionV3 weights the FID term is omitted
(``fid_in_score`` False). Pillow is needed only to read the crops:
``score_candidates`` is the whole computation over images in memory.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..metrics.fid import compute_fid
from ..metrics.image import calc_psnr
from ..metrics.inception import load_inception
from .binary_rate_search import val_paths
from .calc_metrics import to_pm1
from .compress import build_model, load_image

ALPHA = 2.0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config_path", type=str, required=True)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--val_dir", type=str, required=True)
    p.add_argument("--search_results", type=str, required=True,
                   help="binary_rate_search_results.json")
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_images", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the model (default cuda; cpu runs without a card)")
    return p.parse_args(argv)


def make_reconstruct(module, imgs: np.ndarray, batch_size: int = 8
                     ) -> Callable[[float, float], np.ndarray]:
    """reconstruct(beta_rate, beta_vq): the eval forward's ``fake_images``
    of ``imgs`` (float32 [N, H, W, 3] in [-1, 1]) as float32 [N, H, W, 3],
    over the full set (the remainder batch runs at its own shape)."""
    dev = next(module.parameters()).device

    @torch.no_grad()
    def reconstruct(beta_rate: float, beta_vq: float) -> np.ndarray:
        b1 = torch.tensor([beta_rate], dtype=torch.float32, device=dev)
        b2 = torch.tensor([beta_vq], dtype=torch.float32, device=dev)
        outs = []
        for i in range(0, len(imgs), batch_size):
            x = torch.from_numpy(imgs[i:i + batch_size]).to(dev).permute(0, 3, 1, 2)
            fake = module(x.contiguous(), b1, b2, is_train=False)["fake_images"]
            outs.append(fake.float().permute(0, 2, 3, 1).cpu().numpy())
        return np.concatenate(outs, axis=0)
    return reconstruct


def to_u8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] floats -> uint8, the reference script's rounding."""
    return np.round((np.clip(x, -1, 1) / 2 + 0.5) * 255).astype(np.uint8)


def score_candidates(candidates: Sequence[Dict], imgs: np.ndarray,
                     reconstruct: Callable[[float, float], np.ndarray],
                     features_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None
                     ) -> List[Dict]:
    """Each candidate row of the rate search with ``psnr`` (per image,
    averaged), ``fid`` (None without ``features_fn`` or under FID's image
    count), ``score`` = ALPHA * psnr - fid (fid taken as 0 when None),
    ``fid_in_score`` and ``selected`` (the best score of its target rate)."""
    rows = []
    by_rate = defaultdict(list)
    for cand in candidates:
        fakes = reconstruct(cand["beta_rate"], cand["beta_vq"])
        n = len(fakes)
        psnr = float(np.mean([calc_psnr(imgs[i:i + 1], fakes[i:i + 1]) for i in range(n)]))
        fid = compute_fid([to_u8(x) for x in imgs[:n]], [to_u8(x) for x in fakes],
                          features_fn)
        score = ALPHA * psnr - (fid if fid is not None else 0.0)
        row = dict(**cand, psnr=psnr, fid=fid, score=score, fid_in_score=fid is not None)
        rows.append(row)
        by_rate[cand["target_rate"]].append(row)
        print(f"rate={cand['target_rate']} beta_vq={cand['beta_vq']}: psnr={psnr:.3f} "
              f"fid={fid} score={score:.3f}")
    for cands in by_rate.values():
        max(cands, key=lambda r: r["score"])["selected"] = True
    for r in rows:
        r.setdefault("selected", False)
    return rows


def write_csv(rows: Sequence[Dict], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()), extrasaction="ignore")
        w.writeheader()
        w.writerows(rows)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.save_dir, exist_ok=True)
    spec = build_model(args.config_path, args.model_path, args.device)
    with open(args.search_results) as f:
        candidates = json.load(f)
    imgs = np.stack([to_pm1(load_image(p)) for p in val_paths(args.val_dir, args.max_images)])
    features_fn = (load_inception(args.inception_weights, args.device)
                   if args.inception_weights else None)
    rows = score_candidates(candidates, imgs,
                            make_reconstruct(spec.module, imgs, args.batch_size), features_fn)
    out = os.path.join(args.save_dir, "beta_selection_results.csv")
    write_csv(rows, out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
