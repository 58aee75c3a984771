"""Training image grids (train.py:255-275, torchvision's save_image in
numpy and cv2): the port's own copy of otvm_tpu/utils/viz.py."""
from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np


def make_grid(images: Sequence[np.ndarray], nrow: int = 8, pad: int = 2) -> np.ndarray:
    """images: [H, W, 3] (or [H, W]) float in [0, 1] -> one grid image
    [gh, gw, 3], `nrow` to a row, white between them."""
    n = len(images)
    h, w = images[0].shape[:2]
    ncol = (n + nrow - 1) // nrow
    grid = np.ones((ncol * (h + pad) + pad, nrow * (w + pad) + pad, 3), np.float32)
    for i, img in enumerate(images):
        r, c = divmod(i, nrow)
        y = r * (h + pad) + pad
        x = c * (w + pad) + pad
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        grid[y:y + h, x:x + w] = img[..., :3]
    return grid


def save_train_grid(path: str, batch: Mapping[str, np.ndarray], aux: Mapping, max_items: int = 4
                    ) -> None:
    """Rows of [image | GT alpha | predicted alpha | composite] for the first
    `max_items` clips of a float batch (the write_image panel of
    train.py:255-275), written as a JPEG.  aux: `alphas` and `comps`
    [B, S, H, W, *] (make_viz_forward), arrays or CPU tensors."""
    import cv2

    fg, bg, alpha = batch["fg"], batch["bg"], batch["alpha"]
    img = fg * alpha + bg * (1 - alpha)
    preds = np.asarray(aux["alphas"])          # [B, S, H, W, 1]
    comps = np.asarray(aux["comps"])
    b = min(max_items, img.shape[0])
    s = img.shape[1]
    tiles = []
    for i in range(b):
        for t in range(s):
            tiles.append(np.asarray(img[i, t]))
    for i in range(b):
        for t in range(s):
            tiles.append(np.repeat(np.asarray(alpha[i, t]), 3, -1))
    for i in range(b):
        for t in range(s):
            tiles.append(np.repeat(np.clip(preds[i, t], 0, 1), 3, -1))
    for i in range(b):
        for t in range(s):
            tiles.append(np.clip(comps[i, t], 0, 1))
    grid = make_grid(tiles, nrow=b * s)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, (grid[..., ::-1] * 255).astype(np.uint8))
