"""Dilated ResNet-50 with BatchNorm (the 'resnet50_BN' FBA encoder), NCHW.
Counterpart of otvm_tpu/nn/resnet_bn.py.

Against the GN-WS trunk (nn/resnet_gn_ws.py): a 3-conv stem (3x3 s2 -> 64,
3x3 -> 64, 3x3 -> 128, each norm + ReLU) instead of one 7x7, so the
bottlenecks start from 128 channels and the stem's output has 128; plain
convs (no weight standardization); `BNAffine` for every norm.  The dilation
and the pyramid are the GN-WS trunk's: conv_out = (x, c1 128, l1 256, l2
512, l3 1024, l4 2048) at strides 1, 2, 4, 8, 8, 8.  The JAX trunk has no
width-scaled variant, so neither has this one.

The reference ships no checkpoint for this trunk (models/alpha/FBA/
models.py:13 defaults to resnet50_GN_WS), so `convert.load_pth` refuses it;
weights come from `convert.from_jax` or training.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv
from .ops import max_pool_3x3_s2


class BNAffine(nn.Module):
    """BatchNorm2d as the reference reaches it on this trunk: in eval mode
    (FREEZE_BN) with its buffers at their init values (running mean 0,
    variance 1) for ever, so y = x / sqrt(1 + eps) * weight + bias.  The
    weight and bias train; there are no running statistics."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps = eps

    def folded(self):
        """(inv, shift) of shape [1, C, 1, 1]: y = x * inv + shift."""
        root = torch.tensor(1.0 + self.eps, dtype=torch.float32, device=self.weight.device).sqrt()
        inv = self.weight / root
        return inv.view(1, -1, 1, 1), self.bias.view(1, -1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv, shift = self.folded()
        return x * inv.to(x.dtype) + shift.to(x.dtype)


class BottleneckBN(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False,
                 dilation2: int = 1):
        super().__init__()
        out_ch = planes * 4
        self.conv1 = Conv(in_ch, planes, 1, 1, 0, bias=False)
        self.bn1 = BNAffine(planes)
        self.conv2 = Conv(planes, planes, 3, stride, dilation2, dilation2, bias=False)
        self.bn2 = BNAffine(planes)
        self.conv3 = Conv(planes, out_ch, 1, 1, 0, bias=False)
        self.bn3 = BNAffine(out_ch)
        self.downsample = (nn.Sequential(Conv(in_ch, out_ch, 1, stride, 0, bias=False),
                                         BNAffine(out_ch))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


def _dilated_layer_bn(in_ch: int, planes: int, blocks: int, first_dilation: int,
                      rest_dilation: int, stride: int) -> nn.Sequential:
    """otvm_tpu's _DilatedLayerBN: the first block downsamples."""
    layers = [BottleneckBN(in_ch, planes, stride, downsample=True, dilation2=first_dilation)]
    layers += [BottleneckBN(planes * 4, planes, 1, dilation2=rest_dilation)
               for _ in range(1, blocks)]
    return nn.Sequential(*layers)


class ResNet50DilatedBN(nn.Module):
    """The BN FBA encoder trunk: output stride 8, 11 input channels."""

    c1_channels = 128           # the stem's output, the decoder's last skip

    def __init__(self, in_ch: int = 11):
        super().__init__()
        self.conv1 = Conv(in_ch, 64, 3, 2, 1, bias=False)
        self.bn1 = BNAffine(64)
        self.conv2 = Conv(64, 64, 3, 1, 1, bias=False)
        self.bn2 = BNAffine(64)
        self.conv3 = Conv(64, 128, 3, 1, 1, bias=False)
        self.bn3 = BNAffine(128)
        self.layer1 = _dilated_layer_bn(128, 64, 3, 1, 1, 1)
        self.layer2 = _dilated_layer_bn(256, 128, 4, 1, 1, 2)
        self.layer3 = _dilated_layer_bn(512, 256, 6, 1, 2, 1)
        self.layer4 = _dilated_layer_bn(1024, 512, 3, 2, 4, 1)

    def forward(self, x: torch.Tensor):
        c = F.relu(self.bn1(self.conv1(x)))
        c = F.relu(self.bn2(self.conv2(c)))
        c1 = F.relu(self.bn3(self.conv3(c)))
        l1 = self.layer1(max_pool_3x3_s2(c1))
        l2 = self.layer2(l1)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        return (x, c1, l1, l2, l3, l4)
