"""torchvision ResNet-50 trunk, conv1..layer3 (STM encoders), NCHW.

Counterpart of otvm_tpu/nn/resnet.py.  The stages carry STM's names
(res2/res3/res4, models/trimap/STM.py:49-51), so the trunk's state_dict is
the original checkpoint's.  The stem conv is exposed apart from the rest
(`stem_conv` / `stages`) because STM's memory encoder sums extra mask convs
into it before the first norm.

norm: 'frozen_bn' (the reference) or 'gn' (GroupNorm(min(32, C)), the
from-scratch recipe; such checkpoints carry no running stats).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv, FrozenBatchNorm
from .ops import max_pool_3x3_s2


def make_norm(kind: str, channels: int) -> nn.Module:
    if kind == "gn":
        return nn.GroupNorm(min(32, channels), channels, eps=1e-5)
    if kind == "frozen_bn":
        return FrozenBatchNorm(channels)
    raise ValueError(f"unknown trunk norm {kind!r}")


class Bottleneck(nn.Module):
    """torchvision Bottleneck: stride on the 3x3 conv, 1x1 downsample."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, norm: str = "frozen_bn"):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = Conv(in_ch, planes, 1, 1, 0, bias=False)
        self.bn1 = make_norm(norm, planes)
        self.conv2 = Conv(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = make_norm(norm, planes)
        self.conv3 = Conv(planes, out_ch, 1, 1, 0, bias=False)
        self.bn3 = make_norm(norm, out_ch)
        self.downsample = (nn.Sequential(Conv(in_ch, out_ch, 1, stride, 0, bias=False),
                                         make_norm(norm, out_ch))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


def make_layer(in_ch: int, planes: int, blocks: int, stride: int, norm: str) -> nn.Sequential:
    layers = [Bottleneck(in_ch, planes, stride, downsample=True, norm=norm)]
    layers += [Bottleneck(planes * 4, planes, 1, norm=norm) for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ResNet50Trunk(nn.Module):
    """conv1..layer3 of ResNet-50: (r4, r3, r2, c1) at strides 16, 8, 4, 2
    with 16w, 8w, 4w and w channels (w = width, 64 for the real model).
    width/blocks below (64, (3, 4, 6)) build the width-scaled test model."""

    def __init__(self, width: int = 64, blocks: Sequence[int] = (3, 4, 6),
                 norm: str = "frozen_bn"):
        super().__init__()
        w = width
        self.conv1 = Conv(3, w, 7, 2, 3, bias=False)
        self.bn1 = make_norm(norm, w)
        self.res2 = make_layer(w, w, blocks[0], 1, norm)
        self.res3 = make_layer(4 * w, 2 * w, blocks[1], 2, norm)
        self.res4 = make_layer(8 * w, 4 * w, blocks[2], 2, norm)

    def stem_conv(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1(x)

    def stages(self, x: torch.Tensor):
        """x: stem conv output (plus any extra convs), before the norm."""
        c1 = F.relu(self.bn1(x))
        r2 = self.res2(max_pool_3x3_s2(c1))
        r3 = self.res3(r2)
        r4 = self.res4(r3)
        return r4, r3, r2, c1

    def forward(self, x: torch.Tensor):
        return self.stages(self.stem_conv(x))
