"""SSIM (structural similarity) on luma: the perceptual tolerance used to
validate renders against the reference's published image
(Doc/Images/rnl_dragon.png of the reference).

Pure numpy, uniform-window variant (Wang et al. 2004 with box filter):
adequate for golden-image gating, dependency-free.  Copied from
raytracedggx_tpu/utils/ssim.py.
"""

from __future__ import annotations

import numpy as np


def _box(x: np.ndarray, r: int) -> np.ndarray:
    """Box filter with window (2r+1)^2 via cumulative sums, edge-padded."""
    pad = np.pad(x, r, mode="edge")
    c = pad.cumsum(0).cumsum(1)
    c = np.pad(c, ((1, 0), (1, 0)))
    k = 2 * r + 1
    s = (c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k])
    return s / (k * k)


def luma(img: np.ndarray) -> np.ndarray:
    """Rec.601 luma of an (H, W, 3) image in [0, 1]."""
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def ssim(a: np.ndarray, b: np.ndarray, radius: int = 5,
         dynamic_range: float = 1.0) -> float:
    """Mean SSIM between two (H, W) luma or (H, W, 3) images in [0, 1]."""
    if a.ndim == 3:
        a = luma(a)
    if b.ndim == 3:
        b = luma(b)
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    c1 = (0.01 * dynamic_range) ** 2
    c2 = (0.03 * dynamic_range) ** 2
    mu_a = _box(a, radius)
    mu_b = _box(b, radius)
    var_a = _box(a * a, radius) - mu_a * mu_a
    var_b = _box(b * b, radius) - mu_b * mu_b
    cov = _box(a * b, radius) - mu_a * mu_b
    s = (((2 * mu_a * mu_b + c1) * (2 * cov + c2))
         / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)))
    return float(s.mean())


def downsample(img: np.ndarray, factor: int) -> np.ndarray:
    """Box-downsample an (H, W, C) image by an integer factor."""
    h, w = img.shape[:2]
    h2, w2 = h // factor * factor, w // factor * factor
    img = img[:h2, :w2]
    return img.reshape(h2 // factor, factor, w2 // factor, factor,
                       -1).mean(axis=(1, 3))
