"""Image datasets (port of dc_vic_tpu/data/datasets.py).

Host-side numpy pipeline giving HWC float32 images in [-1, 1] (the
reference's Normalize(.5, .5)). Train transform: optional random resize,
random crop (reflect-padded when the image is smaller), horizontal flip.
Eval: the full image. Files are PNG/JPEG/BMP/WebP (read with Pillow, imported
where a file is read) or ``.npy`` arrays of uint8 HWC pixels, which need no
image library. The random resize is bilinear with antialiasing through
``torch.nn.functional.interpolate`` (the JAX package resizes with Pillow).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.registry import DATASET_REGISTRY

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".npy")


def list_images(root: str) -> List[str]:
    return [os.path.join(root, name) for name in sorted(os.listdir(root))
            if name.lower().endswith(IMG_EXTS)]


def load_image(path: str) -> np.ndarray:
    """-> float32 HWC in [-1, 1]."""
    if path.lower().endswith(".npy"):
        arr = np.load(path)
        if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(f"{path}: expected uint8 HWC RGB pixels, got {arr.dtype} "
                             f"{arr.shape}")
    else:
        from PIL import Image
        arr = np.asarray(Image.open(path).convert("RGB"))
    x = arr.astype(np.float32) / 255.0
    return (x - 0.5) * 2.0


def random_resize(x: np.ndarray, rng: np.random.Generator,
                  resize_range: Tuple[float, float]) -> np.ndarray:
    """Rescale by a factor drawn from resize_range (pixels rounded to uint8
    levels first, as the reference resizes 8-bit images)."""
    scale = rng.uniform(*resize_range)
    h, w = x.shape[:2]
    nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
    pix = torch.from_numpy(((x / 2 + 0.5) * 255).astype(np.uint8)).permute(2, 0, 1)[None]
    out = F.interpolate(pix.float(), size=(nh, nw), mode="bilinear", align_corners=False,
                        antialias=True)
    out = torch.clamp(torch.round(out), 0, 255)[0].permute(1, 2, 0).numpy()
    return (out.astype(np.float32) / 255.0 - 0.5) * 2.0


def random_crop(x: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    h, w = x.shape[:2]
    if h < size or w < size:
        x = np.pad(x, ((0, max(0, size - h)), (0, max(0, size - w)), (0, 0)), mode="reflect")
        h, w = x.shape[:2]
    top = rng.integers(0, h - size + 1)
    left = rng.integers(0, w - size + 1)
    return x[top:top + size, left:left + size]


class BaseImageDataset:
    """Indexable dataset of image files with the reference transforms."""

    def __init__(self, paths: Sequence[str], image_size: Optional[int] = None,
                 resize_range: Optional[Tuple[float, float]] = None, is_train: bool = True):
        self.paths = list(paths)
        self.image_size = image_size
        self.resize_range = resize_range
        self.is_train = is_train

    def __len__(self) -> int:
        return len(self.paths)

    def get(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        x = load_image(self.paths[idx])
        if self.is_train:
            if rng is None:
                raise ValueError("a training item needs an rng")
            if self.resize_range:
                x = random_resize(x, rng, tuple(self.resize_range))
            if self.image_size:
                x = random_crop(x, self.image_size, rng)
            if rng.random() < 0.5:
                x = x[:, ::-1].copy()
        return {"real_images": x, "path": self.paths[idx]}


@DATASET_REGISTRY.register("openimage_ImageDataset")
class OpenImageImageDataset(BaseImageDataset):
    """OpenImages ``train_{i}`` subsets, or the validation split."""

    def __init__(self, root_dir: str, subset_list: Optional[Sequence[int]] = None,
                 image_size: int = 256, resize_range=None, is_train: bool = True):
        paths: List[str] = []
        if is_train:
            for i in subset_list or []:
                sub = os.path.join(root_dir, f"train_{i}")
                if os.path.isdir(sub):
                    paths.extend(list_images(sub))
        else:
            val = os.path.join(root_dir, "validation")
            paths = list_images(val if os.path.isdir(val) else root_dir)
        super().__init__(paths, image_size=image_size, resize_range=resize_range,
                         is_train=is_train)


@DATASET_REGISTRY.register("Kodak_ImageDataset")
class KodakImageDataset(BaseImageDataset):
    """The Kodak evaluation set."""

    def __init__(self, root_dir: str, is_train: bool = False, **kw):
        if is_train:
            raise ValueError("Kodak is evaluation-only")
        super().__init__(list_images(root_dir), is_train=False)


def build_dataset(cfg: Dict, is_train: bool):
    """Keyed by name + type (``openimage`` + ``ImageDataset``)."""
    cfg = dict(cfg)
    key = f"{cfg.pop('name')}_{cfg.pop('type', 'ImageDataset')}"
    return DATASET_REGISTRY.get(key)(is_train=is_train, **cfg)
