"""Dilated ResNet-50 with GroupNorm + weight standardization (FBA encoder),
NCHW.  Counterpart of otvm_tpu/nn/resnet_gn_ws.py.

Output stride 8: layer3 and layer4 keep stride 1 and dilate instead
(models/alpha/FBA/models.py:236-249):
  * layer3: the first block's 3x3 conv has dilation 1, the rest 2;
  * layer4: the first block's 3x3 conv has dilation 2, the rest 4.
conv1 takes 11 channels (3 image + 6 clicks + 2 trimap).  forward returns
conv_out = (x, c1, l1, l2, l3, l4) at strides 1, 2, 4, 8, 8, 8.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import GroupNorm32, WSConv
from .ops import max_pool_3x3_s2


class BottleneckGN(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False,
                 dilation2: int = 1):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = WSConv(in_ch, planes, 1, 1, 0, bias=False)
        self.bn1 = GroupNorm32(planes)
        self.conv2 = WSConv(planes, planes, 3, stride, dilation2, dilation2, bias=False)
        self.bn2 = GroupNorm32(planes)
        self.conv3 = WSConv(planes, out_ch, 1, 1, 0, bias=False)
        self.bn3 = GroupNorm32(out_ch)
        self.downsample = (nn.Sequential(WSConv(in_ch, out_ch, 1, stride, 0, bias=False),
                                         GroupNorm32(out_ch))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class BasicBlockGN(nn.Module):
    """resnet_GN_WS.BasicBlock (used by the FBA refinement head)."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = WSConv(planes, planes, 3, 1, 1, bias=False)
        self.bn1 = GroupNorm32(planes)
        self.conv2 = WSConv(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = GroupNorm32(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + x)


def _dilated_layer(in_ch: int, planes: int, blocks: int, first_dilation: int,
                   rest_dilation: int, stride: int) -> nn.Sequential:
    layers = [BottleneckGN(in_ch, planes, stride, downsample=True, dilation2=first_dilation)]
    layers += [BottleneckGN(planes * 4, planes, 1, dilation2=rest_dilation)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ResNet50DilatedGNWS(nn.Module):
    """FBA encoder trunk.  width/blocks below (64, (3, 4, 6, 3)) build the
    width-scaled test model (same module tree, fewer channels and blocks)."""

    def __init__(self, width: int = 64, blocks: Sequence[int] = (3, 4, 6, 3),
                 in_ch: int = 11):
        super().__init__()
        w, b = width, blocks
        self.c1_channels = w        # the stem's output, the decoder's last skip
        self.conv1 = WSConv(in_ch, w, 7, 2, 3, bias=False)
        self.bn1 = GroupNorm32(w)
        self.layer1 = _dilated_layer(w, w, b[0], 1, 1, 1)
        self.layer2 = _dilated_layer(4 * w, 2 * w, b[1], 1, 1, 2)
        self.layer3 = _dilated_layer(8 * w, 4 * w, b[2], 1, 2, 1)
        self.layer4 = _dilated_layer(16 * w, 8 * w, b[3], 2, 4, 1)

    def forward(self, x: torch.Tensor):
        c1 = F.relu(self.bn1(self.conv1(x)))
        l1 = self.layer1(max_pool_3x3_s2(c1))
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        return (x, c1, l1, l2, l3, l4)
