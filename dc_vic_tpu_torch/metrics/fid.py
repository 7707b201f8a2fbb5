"""FID with the HiFiC 256-patch protocol (ref: scripts/calc_metrics.py:220-320);
the port's copy of dc_vic_tpu/metrics/fid.py.

Protocol: each image is cut into 256x256 patch grids under TWO offset
tilings (origin (0,0) and (128,128)); patches from all images pool into one
set per side; FID = Frechet distance between Gaussian fits of InceptionV3
pool3 features (2048-d, pytorch-fid convention). Refuses to run with < 50
images (ref: calc_metrics.py:236-238).

InceptionV3 weights are not distributable here; the feature extractor is
pluggable (fid_features_fn). Without weights the metric reports unavailable.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

MIN_IMAGES = 50
PATCH = 256
OFFSETS = ((0, 0), (128, 128))


def extract_patch_grid(img: np.ndarray, offset: Tuple[int, int]) -> List[np.ndarray]:
    """Non-overlapping 256px patches of one HWC image starting at offset;
    partial border patches are dropped (HiFiC protocol)."""
    oy, ox = offset
    H, W = img.shape[:2]
    out = []
    for t in range(oy, H - PATCH + 1, PATCH):
        for l in range(ox, W - PATCH + 1, PATCH):
            out.append(img[t:t + PATCH, l:l + PATCH])
    return out


def collect_patches(images: List[np.ndarray]) -> List[np.ndarray]:
    patches: List[np.ndarray] = []
    for img in images:
        for off in OFFSETS:
            patches.extend(extract_patch_grid(img, off))
    return patches


def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 (S1 S2)^(1/2))."""
    from scipy import linalg

    diff = mu1 - mu2
    # sqrtm's disp argument is gone from SciPy 1.18 on; without it the call
    # returns the same root on every version
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def compute_fid(real_images: List[np.ndarray], fake_images: List[np.ndarray],
                features_fn: Optional[Callable[[np.ndarray], np.ndarray]],
                batch_size: int = 32) -> Optional[float]:
    """images: list of HWC uint8 arrays. features_fn maps a [N,256,256,3]
    uint8 batch to [N, D] features (InceptionV3 pool3). Returns None when
    the protocol or weights are unavailable."""
    if len(real_images) < MIN_IMAGES or features_fn is None:
        return None

    def feats(images):
        patches = collect_patches(images)
        out = []
        for i in range(0, len(patches), batch_size):
            out.append(np.asarray(
                features_fn(np.stack(patches[i:i + batch_size]))))
        return np.concatenate(out, axis=0)

    mu_r, s_r = gaussian_stats(feats(real_images))
    mu_f, s_f = gaussian_stats(feats(fake_images))
    return frechet_distance(mu_r, s_r, mu_f, s_f)


def load_inception_features(weights_path: Optional[str]):
    """InceptionV3 pool3 feature extractor. Weights must be supplied as a
    torchvision-layout state dict (pytorch-fid's FID-adjusted InceptionV3);
    returns None when unavailable."""
    if not weights_path:
        return None
    from .inception import load_inception  # deferred: heavy module
    return load_inception(weights_path)
