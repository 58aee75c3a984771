"""Trimaps from alpha mattes and from trimap images, on the host (numpy,
cv2): the port's own copy of otvm_tpu/data/trimap.py.

  * `trimap_from_alpha`: the eval protocol's GT trimap, a fixed dilation of
    the unknown band (make_trimap_gt, models/alpha/model.py:342-378);
  * `random_trimap_from_alpha`: training-time synthesis with a random
    width and an optional close first (dataset.py:200-229);
  * `trimap_from_png`: a trimap image decoded to one-hot (dataset.py:878-893).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _dilate(mask: np.ndarray, radius: int) -> np.ndarray:
    if radius <= 0:
        return mask
    import cv2
    kernel = np.ones((2 * radius + 1, 2 * radius + 1), np.uint8)
    return cv2.dilate(mask.astype(np.uint8), kernel).astype(mask.dtype)


def trimap_from_alpha(alpha: np.ndarray, dilate_radius: int, eps: float = 0.0
                      ) -> np.ndarray:
    """alpha [H, W] in [0, 1] -> one-hot trimap [H, W, 3] (bg, unknown, fg):
    the unknown band (0 < alpha < 1) dilated by `dilate_radius`, elsewhere
    floor(2 * alpha).  The eval protocol's widths narrow / medium / wide
    are radii 5 / 12 / 20 (config.TRIMAP_WIDTH_KERNELS)."""
    a = alpha.copy()
    if eps > 0:
        a[a < eps] = 0.0
        a[a > 1 - eps] = 1.0
    unknown = ((a > 0) & (a < 1)).astype(np.float32)
    unknown = _dilate(unknown, dilate_radius)
    label = np.where(unknown > 0.5, 1, (2.0 * a).astype(np.int64))
    return np.eye(3, dtype=np.float32)[label]


def random_trimap_from_alpha(rng: np.random.RandomState, alpha: np.ndarray,
                             eps: float = 0.0, max_radius: int = 25,
                             close_first: bool = False,
                             ignore_region: Optional[np.ndarray] = None
                             ) -> np.ndarray:
    """Training-time trimap of random width: a dilation radius drawn from
    0..max_radius (models/trimap/model.py:37-54), after an optional close
    of radius 0..5; `ignore_region` pixels become background."""
    a = alpha.copy()
    if eps > 0:
        a[a < eps] = 0.0
        a[a > 1 - eps] = 1.0
    trimap = ((a > 0) & (a < 1)).astype(np.float32)
    trimap_ori = trimap
    if close_first:
        r = rng.randint(0, 6)  # the reference's random.randint(0, 5) is inclusive
        inv = 1.0 - trimap
        if ignore_region is not None:
            inv[ignore_region] = 0
        inv = _dilate(inv, r)
        trimap = 1.0 - inv
        if ignore_region is not None:
            trimap[ignore_region] = 0
        trimap = _dilate(trimap, r)
    radius = rng.randint(0, max_radius + 1)
    trimap = _dilate(trimap, radius)
    if close_first:
        trimap = trimap + trimap_ori
    label = np.where(trimap > 0.5, 1, 2 * (a > 0.5).astype(np.int64))
    if ignore_region is not None:
        label[ignore_region] = 0
    return np.eye(3, dtype=np.float32)[label]


def trimap_from_png(img: np.ndarray) -> np.ndarray:
    """A decoded trimap image -> one-hot [H, W, 3].  Gray {0, 128, 255}:
    bg = 0, fg = the maximum, unknown = the largest remaining value.
    Colour (BGR): fg = channel 1 above 1, unknown = channel 2, bg = neither."""
    if img.ndim == 2:
        out = np.zeros((*img.shape, 3), np.float32)
        mx = img.max()
        out[..., 0][img == 0] = 1
        out[..., 2][img == mx] = 1
        rest = img.copy()
        rest[img == mx] = 0
        out[..., 1][(rest == rest.max()) & (out[..., 0] == 0) & (out[..., 2] == 0)] = 1
        return out
    t = img > 1
    out = np.zeros((*img.shape[:2], 3), np.float32)
    out[..., 0][~(t[..., 1] | t[..., 2])] = 1
    out[..., 1][t[..., 2]] = 1
    out[..., 2][t[..., 1]] = 1
    return out
