"""Build the beta-calibration validation set: random crops of validation
photographs and their frozen-VQGAN token maps (port of
``scripts/build_openimage_val_dataset.py``; writes ``images/val_NNNNN.png``
and ``vq_indices/val_NNNNN.npy``, uint8 when n_embed <= 256).

    python3 -m dc_vic_tpu_torch.tools.build_val_dataset --config_path \\
        config/dc_vic_patchgan.yaml --src_dir openimages_val/ --save_dir val/ \\
        [--model_path ckpt.pth.tar] [--num_images 2048] [--crop 256] [--seed 0] \\
        [--device cuda]

The sources are shuffled with ``numpy.random.default_rng(seed)``, which then
draws each crop's corner; sources smaller than the crop or unreadable are
skipped. Pillow is needed only for the files: ``crop_and_tokenize`` is the
whole computation over images in memory.
"""
from __future__ import annotations

import argparse
import os
from glob import glob
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from .compress import build_model, load_image, save_image


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config_path", type=str, required=True,
                   help="model config (for the frozen VQGAN)")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--src_dir", type=str, required=True)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--num_images", type=int, default=2048)
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the model (default cuda; cpu runs without a card)")
    return p.parse_args(argv)


@torch.no_grad()
def tokenize(module, crops: np.ndarray) -> np.ndarray:
    """Token maps [N, crop / 8, crop / 8] of uint8 [N, crop, crop, 3] crops
    (the VQGAN encode and argmin on the model's device), uint8 when the
    codebook has at most 256 entries, else int32."""
    dev = next(module.parameters()).device
    x = torch.from_numpy(crops).to(dev).permute(0, 3, 1, 2).contiguous().float() / 255.0
    _, idx = module.vq_encode((x - 0.5) * 2.0)
    return idx.cpu().numpy().astype(np.uint8 if module.n_embed <= 256 else np.int32)


def crop_and_tokenize(module, sources: Iterable[Optional[np.ndarray]], rng: np.random.Generator,
                      num_images: int = 2048, crop: int = 256, batch_size: int = 16
                      ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Up to ``num_images`` random ``crop`` x ``crop`` crops of the uint8
    [H, W, 3] sources, in their order (None and sources under the crop are
    skipped), corners drawn from ``rng``; tokenized ``batch_size`` at a
    time. Returns (names val_NNNNN, crops [N, crop, crop, 3] uint8, token
    maps)."""
    names, crops, maps, pending = [], [], [], []
    for img in sources:
        if len(names) >= num_images:
            break
        if img is None:
            continue
        H, W = img.shape[:2]
        if H < crop or W < crop:
            continue
        t = rng.integers(0, H - crop + 1)
        l = rng.integers(0, W - crop + 1)
        pending.append(img[t:t + crop, l:l + crop])
        names.append(f"val_{len(names):05d}")
        if len(pending) == batch_size or len(names) == num_images:
            crops.extend(pending)
            maps.append(tokenize(module, np.stack(pending)))
            pending = []
    if pending:           # the sources ran out before num_images
        crops.extend(pending)
        maps.append(tokenize(module, np.stack(pending)))
    if not names:
        raise ValueError(f"no source is at least {crop} x {crop}")
    return names, np.stack(crops), np.concatenate(maps)


def _read(path: str) -> Optional[np.ndarray]:
    try:
        return load_image(path)
    except OSError:
        return None


def main(argv=None):
    args = parse_args(argv)
    img_dir = os.path.join(args.save_dir, "images")
    idx_dir = os.path.join(args.save_dir, "vq_indices")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(idx_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    paths = sorted(glob(os.path.join(args.src_dir, "*.jpg"))
                   + glob(os.path.join(args.src_dir, "*.png")))
    rng.shuffle(paths)
    module = build_model(args.config_path, args.model_path, args.device).module
    names, crops, maps = crop_and_tokenize(module, (_read(p) for p in paths), rng,
                                           args.num_images, args.crop, args.batch_size)
    for name, c, m in zip(names, crops, maps):
        save_image(os.path.join(img_dir, f"{name}.png"), c)
        np.save(os.path.join(idx_dir, f"{name}.npy"), m)
    print(f"wrote {len(names)} crops + token maps to {args.save_dir}")


if __name__ == "__main__":
    main()
