"""Video-matting quality metrics: SAD, MSE, Gradient, Connectivity, SSDA,
dtSSD, MESSDdt, and the trimap IoUs.  The port's own copy of
otvm_tpu/eval/metrics.py (the paper's definitions, the reference's
utils/tmp/metric.py), on the host in numpy, scipy.ndimage and cv2 as in the
JAX package.

Inputs are alpha mattes scaled to [0, 255], [B, H, W] (B = the frames of a
clip for the temporal metrics); a mask marks the scored pixels with 128
(the unknown region of the GT trimap), else 0 < target < 255 is scored.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage


def _default_mask(target: np.ndarray, mask: Optional[np.ndarray]) -> np.ndarray:
    if mask is None:
        return ((target > 0) & (target < 255)).astype(np.float32)
    return (mask == 128).astype(np.float32)


def gen_gauss_kernel(sigma: float = 1.4) -> Tuple[np.ndarray, np.ndarray]:
    """metric.py:26-46: the normalized gaussian-derivative kernel pair."""
    eps = 1e-2
    hsize = int(np.ceil(sigma * np.sqrt(-2 * np.log(np.sqrt(2 * math.pi) * sigma * eps))))
    size = 2 * hsize + 1

    def gauss(x):
        return np.exp(-x ** 2 / (2 * sigma ** 2)) / (sigma * np.sqrt(2 * math.pi))

    def dgauss(x):
        return -x * gauss(x) / sigma ** 2

    hx = np.zeros((size, size), np.float32)
    for i in range(size):
        for j in range(size):
            hx[i, j] = gauss(i - hsize) * dgauss(j - hsize)
    hx = hx / np.sqrt(np.sum(hx ** 2))
    return hx, hx.T


_HX, _HY = gen_gauss_kernel(1.4)


def batch_sad(pred, target, mask=None):
    """metric.py:177-182: sum |err| / 255 over the mask, / 1000, per frame."""
    mask = _default_mask(target, mask)
    err = np.abs(pred - target) / 255.0
    return (err * mask).reshape(len(pred), -1).sum(-1) / 1000.0


def batch_mse(pred, target, mask=None):
    mask = _default_mask(target, mask)
    err = (pred - target) / 255.0
    num = mask.reshape(len(pred), -1).sum(-1) + 1.0
    return ((err ** 2) * mask).reshape(len(pred), -1).sum(-1) / num


def batch_gradient(pred, target, mask=None):
    """metric.py:191-204: squared error of the gaussian gradient magnitudes
    (the reference's flipped-kernel conv with replicate padding is
    ndimage.convolve with mode 'nearest')."""
    mask = _default_mask(target, mask)
    p = pred / 255.0
    t = target / 255.0
    out = np.zeros(len(pred), np.float32)
    for i in range(len(pred)):
        px = ndimage.convolve(p[i], _HX, mode="nearest")
        py = ndimage.convolve(p[i], _HY, mode="nearest")
        tx = ndimage.convolve(t[i], _HX, mode="nearest")
        ty = ndimage.convolve(t[i], _HY, mode="nearest")
        pa = np.sqrt(px ** 2 + py ** 2)
        ta = np.sqrt(tx ** 2 + ty ** 2)
        out[i] = (((pa - ta) ** 2) * mask[i]).sum()
    return out


def _largest_region(x: np.ndarray) -> np.ndarray:
    """metric.py:16-24, 4-connected labels (ndimage.label)."""
    cc, num = ndimage.label(x)
    omega = np.zeros_like(x, dtype=np.float32)
    if num > 0:
        counts = np.bincount(cc.flatten())[1:]
        omega[cc == (np.argmax(counts) + 1)] = 1
    return omega


def batch_connectivity(pred, target, mask=None, step=0.1, theta=0.15):
    """metric.py:206-234."""
    mask = _default_mask(target, mask)
    p = pred / 255.0
    t = target / 255.0
    B = len(pred)
    thresh_steps = np.arange(0, 1 + step, step)
    l_map = -np.ones_like(p)
    for k in range(1, len(thresh_steps)):
        mask_k = (p >= thresh_steps[k]) & (t >= thresh_steps[k])
        for i in range(B):
            omega = _largest_region(mask_k[i])
            flag = (l_map[i] == -1) & (omega == 0)
            l_map[i][flag] = thresh_steps[k - 1]
    l_map[l_map == -1] = 1
    pd = p - l_map
    td = t - l_map
    p_phi = 1 - pd * (pd >= theta)
    t_phi = 1 - td * (td >= theta)
    return (np.abs(p_phi - t_phi) * mask).reshape(B, -1).sum(-1)


def ssda(pred, target, mask=None):
    """metric.py:244-250 -> (per-frame error, per-frame count)."""
    mask = _default_mask(target, mask)
    p = pred / 255.0
    t = target / 255.0
    err = np.sqrt((((p - t) ** 2) * mask).reshape(len(pred), -1).sum(-1))
    num = mask.reshape(len(pred), -1).sum(-1) + 1.0
    return err, num


def dtssd(pred, target, mask=None):
    """metric.py:252-264: SSD of the temporal differences."""
    mask = _default_mask(target, mask)
    p = pred / 255.0
    t = target / 255.0
    dp = p[1:] - p[:-1]
    dt_ = t[1:] - t[:-1]
    m0 = mask[:-1]
    err = np.sqrt((((dp - dt_) ** 2) * m0).reshape(len(m0), -1).sum(-1))
    num = m0.reshape(len(m0), -1).sum(-1) + 1.0
    return err, num


def messddt(pred, target, mask=None):
    """metric.py:266-302: the motion-compensated temporal error, frames
    warped by the target's Farneback flow.  As in the JAX package, the flow
    cv2 returns as (dx, dy) is added to coordinates stacked (y, x): the
    horizontal motion moves the row index (ROADMAP.md §3, "From the
    reference side"; tests/test_torch_metrics.py shows it)."""
    import cv2

    mask = _default_mask(target, mask)
    flows = [cv2.calcOpticalFlowFarneback(
        target[i].astype(np.uint8), target[i + 1].astype(np.uint8), None,
        0.5, 5, 10, 2, 7, 1.5, cv2.OPTFLOW_FARNEBACK_GAUSSIAN)
        for i in range(len(target) - 1)]
    flow = np.rint(np.asarray(flows)).astype(np.int64)

    p = pred / 255.0
    t = target / 255.0
    p0, p1 = p[:-1], p[1:]
    t0, t1 = t[:-1], t[1:]
    m0, m1 = mask[:-1], mask[1:]
    B, h, w = t0.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack([yy, xx], axis=2)[None].repeat(B, 0)
    cn = coords + flow
    cy = np.clip(cn[..., 0], 0, h - 1)
    cx = np.clip(cn[..., 1], 0, w - 1)
    idx = cy * w + cx

    def take(arr):
        return np.stack([arr[i].reshape(-1)[idx[i].reshape(-1)].reshape(h, w)
                         for i in range(B)])
    p1w, t1w, m1w = take(p1), take(t1), take(m1)
    err_map = (p0 - t0) ** 2 * m0 - (p1w - t1w) ** 2 * m1w
    err = np.abs(err_map).reshape(B, -1).sum(-1)
    num = m0.reshape(B, -1).sum(-1) + 1.0
    return err, num


def trimap_iou(pred3: np.ndarray, gt3: np.ndarray) -> float:
    """Mean 3-class IoU of two trimaps, one-hot or probabilities [..., 3]
    (label_iou of their argmaxes)."""
    return label_iou(np.argmax(pred3, axis=-1), np.argmax(gt3, axis=-1))


def label_iou(p: np.ndarray, g: np.ndarray, n_classes: int = 3) -> float:
    """Mean IoU of integer label maps (any shape), pixels pooled over every
    frame, absent classes skipped, in 0-1.  Not the reference's in-training
    number: that is `reference_iou`."""
    ious = []
    for c in range(n_classes):
        inter = np.logical_and(p == c, g == c).sum()
        union = np.logical_or(p == c, g == c).sum()
        if union > 0:
            ious.append(inter / union)
    return float(np.mean(ious)) if ious else 1.0


def reference_iou(p: np.ndarray, g: np.ndarray, n_classes: int = 3) -> float:
    """The reference's in-training IoU (train_s1_trimap.py:287-303): the
    IoU of each (sample, frame) with 1e-4 added to both its terms (an
    absent class scores 100), averaged per class, then over the classes,
    x100.  p, g: integer label maps [..., H, W]."""
    flat_p = p.reshape(-1, p.shape[-2] * p.shape[-1])
    flat_g = g.reshape(-1, g.shape[-2] * g.shape[-1])
    per_class = []
    for c in range(n_classes):
        x = flat_p == c
        y = flat_g == c
        i = np.logical_and(x, y).sum(-1).astype(np.float64)
        u = np.logical_or(x, y).sum(-1).astype(np.float64)
        per_class.append(((i + 1e-4) / (u + 1e-4)).mean() * 100.0)
    return float(np.mean(per_class))


def video_metrics(pred, target, mask=None):
    """The 7 metrics of one clip -> dict of floats: the per-frame ones
    averaged over frames, the ratio ones as sum(err) / sum(num), as the
    reference aggregates them."""
    out = {
        "SAD": float(batch_sad(pred, target, mask).mean()),
        "MSE": float(batch_mse(pred, target, mask).mean()),
        "Grad": float(batch_gradient(pred, target, mask).mean()),
        "Conn": float(batch_connectivity(pred, target, mask).mean()),
    }
    for name, fn in (("SSDA", ssda), ("dtSSD", dtssd), ("MESSDdt", messddt)):
        err, num = fn(pred, target, mask)
        out[name] = float(err.sum() / num.sum())
    return out
