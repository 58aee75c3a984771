"""Shape and resampling primitives (NCHW), counterparts of otvm_tpu/nn/ops.py.

The JAX package reproduces PyTorch's own semantics for these, so here they
are the PyTorch calls themselves:

  * resize_bilinear  == F.interpolate(mode='bilinear', align_corners=False)
  * adaptive_avg_pool == F.adaptive_avg_pool2d (floor/ceil window bounds)
  * max_pool_3x3_s2  == F.max_pool2d(3, 2, 1) (ResNet stems)
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    """NCHW bilinear resize, align_corners=False."""
    out_hw = (int(out_hw[0]), int(out_hw[1]))
    if tuple(x.shape[-2:]) == out_hw:
        return x
    return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=False)


def upsample_x2(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, (x.shape[-2] * 2, x.shape[-1] * 2))


def adaptive_avg_pool(x: torch.Tensor, out_hw: Sequence[int]) -> torch.Tensor:
    return F.adaptive_avg_pool2d(x, tuple(out_hw))


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def divide_pad_amounts(h: int, w: int, d: int):
    """(lw, uw, lh, uh) pad so H, W become multiples of d; split-center."""
    new_h = h + (d - h % d) % d
    new_w = w + (d - w % d) % d
    lh, uh = (new_h - h) // 2, (new_h - h) - (new_h - h) // 2
    lw, uw = (new_w - w) // 2, (new_w - w) - (new_w - w) // 2
    return (lw, uw, lh, uh)
