"""Shape and resampling primitives (NCHW), counterparts of otvm_tpu/nn/ops.py.

The JAX package reproduces PyTorch's own semantics for these, so here they
are the PyTorch calls themselves:

  * resize_bilinear  == F.interpolate(mode='bilinear', align_corners=False)
  * adaptive_avg_pool == F.adaptive_avg_pool2d (floor/ceil window bounds)
  * max_pool_3x3_s2  == F.max_pool2d(3, 2, 1) (ResNet stems)

Under torch.use_deterministic_algorithms(True) the first two, and
reflect_pad, take forms whose backward is deterministic: torch's CUDA
backward of bilinear interpolation, adaptive average pooling and reflect
padding adds with atomics (in an order the blocks' timing sets), and
torch refuses them in that mode.  The resize and the pooling become
products with their interpolation or pooling matrices along each axis (made
on the input's device, so a CUDA graph can capture them), equal to the
torch calls to fp rounding; the padding becomes a concatenation of flipped
slices, bit for bit the same values.  So the train step is repeatable in
that mode, and its CUDA-graph replay can be held to the eager step bit for
bit (tools/train_graphs_check.py).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _separable(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """rows @ x @ cols^T over the last two axes, in fp32 (as torch's
    kernels accumulate), rounded once to x's dtype."""
    return torch.matmul(torch.matmul(rows, x.float()), cols.t()).to(x.dtype)


def _interpolation_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] fp32: torch's bilinear weights along one axis
    (align_corners=False: source (i + 0.5) * n_in / n_out - 0.5, clamped
    at 0; the upper neighbour clamped at n_in - 1)."""
    src = ((torch.arange(n_out, device=device, dtype=torch.float32) + 0.5) * (n_in / n_out)
           - 0.5).clamp(min=0)
    lo = src.floor()
    frac = (src - lo)[:, None]
    lo = lo.long()[:, None]
    cols = torch.arange(n_in, device=device)
    return (cols == lo) * (1 - frac) + (cols == (lo + 1).clamp(max=n_in - 1)) * frac


def _pooling_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] fp32: torch's adaptive average window along one axis,
    [floor(i * n_in / n_out), ceil((i + 1) * n_in / n_out))."""
    i = torch.arange(n_out, device=device)
    start, end = (i * n_in) // n_out, ((i + 1) * n_in + n_out - 1) // n_out
    cols = torch.arange(n_in, device=device)
    window = (cols >= start[:, None]) & (cols < end[:, None])
    return window / (end - start)[:, None].float()


def resize_bilinear(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """NCHW bilinear resize, align_corners=False."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    if torch.are_deterministic_algorithms_enabled():
        (h, w), dev = x.shape[-2:], x.device
        return _separable(x, _interpolation_matrix(h, out_hw[0], dev),
                          _interpolation_matrix(w, out_hw[1], dev))
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)


def upsample_x2(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))


def adaptive_avg_pool(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    if torch.are_deterministic_algorithms_enabled():
        (h, w), dev = x.shape[-2:], x.device
        return _separable(x, _pooling_matrix(h, int(out_hw[0]), dev),
                          _pooling_matrix(w, int(out_hw[1]), dev))
    return F.adaptive_avg_pool2d(x, tuple(out_hw))


class AdaptiveAvgPool(torch.nn.Module):
    """nn.AdaptiveAvgPool2d as adaptive_avg_pool (no parameters, so the
    same state_dict)."""

    def __init__(self, size: int):
        super().__init__()
        self.size = (size, size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool(x, self.size)


def reflect_pad(x: torch.Tensor, pad: Sequence[int]) -> torch.Tensor:
    """F.pad(x, pad, mode="reflect") for pads on the last two axes, (left,
    right, top, bottom)."""
    if not torch.are_deterministic_algorithms_enabled():
        return F.pad(x, tuple(pad), mode="reflect")
    for axis, (lo, hi) in ((-1, pad[0:2]), (-2, pad[2:4])):
        if not (lo or hi):
            continue
        n = x.shape[axis]
        x = torch.cat([x.narrow(axis, 1, lo).flip(axis), x,
                       x.narrow(axis, n - 1 - hi, hi).flip(axis)], axis)
    return x


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def divide_pad_amounts(h: int, w: int, d: int):
    """(lw, uw, lh, uh) pad so H, W become multiples of d; split-center."""
    new_h = h + (d - h % d) % d
    new_w = w + (d - w % d) % d
    lh, uh = (new_h - h) // 2, (new_h - h) - (new_h - h) // 2
    lw, uw = (new_w - w) // 2, (new_w - w) - (new_w - w) // 2
    return (lw, uw, lh, uh)
