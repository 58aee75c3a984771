"""Conv and norm primitives (NCHW), counterparts of otvm_tpu/nn/layers.py.

  * Conv            - nn.Conv2d (OIHW weight, symmetric padding).
  * WSConv          - weight-standardized conv (FBA layers_WS.Conv2d): per
                      output channel, w -= mean(w); w /= sqrt(var_unbiased +
                      1e-12) + 1e-5, in fp32, then cast to the input dtype.
  * GroupNorm32     - GroupNorm(min(32, C), C), eps 1e-5.
  * FrozenBatchNorm - BatchNorm2d that always normalizes with its running
                      stats, folded to x * inv + (bias - mean * inv).
  * ServingGroupNorm - a frozen model's GroupNorm, with the activation after
                      it fused: kernels/group_norm.py (freeze_for_inference).

Random init follows flax's defaults so a randomly initialised port sees the
activation scale of the JAX package: lecun_normal for Conv, he_normal for
WSConv (both truncated normals), zero biases, norm scale 1 / bias 0, BN
running stats 0 and 1.  The values differ from JAX's: the generators differ.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import group_norm as gn

Conv = nn.Conv2d   # (in, out, kernel, stride, padding, dilation, bias=...)


class WSConv(nn.Conv2d):
    """Weight-standardized Conv2d (layers_WS.py:13-23)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 padding: int = 0, dilation: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding, dilation, bias=bias)

    def standardized_weight(self) -> torch.Tensor:
        """The standardized kernel, fp32."""
        w = self.weight.float()
        w = w - w.mean(dim=(1, 2, 3), keepdim=True)
        n = w[0].numel()
        var = (w * w).sum(dim=(1, 2, 3), keepdim=True) / max(n - 1, 1)
        return w / (torch.sqrt(var + 1e-12) + 1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.standardized_weight().to(x.dtype), bias, self.stride,
                        self.padding, self.dilation)


class GroupNorm32(nn.GroupNorm):
    def __init__(self, channels: int):
        super().__init__(min(32, channels), channels, eps=1e-5)


class FrozenBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d permanently in eval mode.  Subclassing BatchNorm2d keeps
    torchvision's state_dict names (num_batches_tracked included), so
    released checkpoints load strictly."""

    def folded(self):
        """(inv, shift) of shape [1, C, 1, 1]: y = x * inv + shift."""
        inv = self.weight / torch.sqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * inv
        return inv.view(1, -1, 1, 1), shift.view(1, -1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv, shift = self.folded()
        return x * inv.to(x.dtype) + shift.to(x.dtype)


class _Affine(nn.Module):
    """A frozen norm folded once: y = x * inv + shift."""

    def __init__(self, inv: torch.Tensor, shift: torch.Tensor):
        super().__init__()
        self.register_buffer("inv", inv)
        self.register_buffer("shift", shift)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.inv.to(x.dtype) + self.shift.to(x.dtype)


class ServingGroupNorm(nn.Module):
    """A GroupNorm of a model frozen for serving, and the activation that
    followed it ('relu', 'leaky_relu' or None): kernels/group_norm.py's op,
    the kernels on CUDA, F.group_norm and the activation on the CPU.  Holds
    the norm's own weight and bias (their names in the state_dict kept)."""

    def __init__(self, norm: nn.GroupNorm, act: Optional[str] = None, slope: float = 0.01):
        super().__init__()
        self.num_groups, self.eps = norm.num_groups, norm.eps
        self.weight, self.bias = norm.weight, norm.bias
        self.act, self.slope = act, slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            # the kernels take NCHW-contiguous tensors; torch's CUDA GroupNorm
            # makes the same copy itself (a convolution fed a permuted NHWC
            # frame returns channels_last)
            x = x.contiguous()
        return gn.group_norm(x, self.num_groups, self.weight, self.bias, self.eps, self.act,
                             self.slope)


def _activation(module: nn.Module) -> Optional[Tuple[str, float]]:
    """(act, slope) of an activation module ServingGroupNorm can fuse."""
    if isinstance(module, nn.ReLU):
        return "relu", 0.0
    if isinstance(module, nn.LeakyReLU):
        return "leaky_relu", module.negative_slope
    return None


@torch.no_grad()
def freeze_for_inference(module: nn.Module) -> nn.Module:
    """In place, for serving weights that no longer change: every WSConv
    becomes a Conv2d holding its standardized kernel (in the weight's dtype,
    as forward casts it), every frozen norm (FrozenBatchNorm, the BN FBA
    trunk's BNAffine: whatever has `folded()`) an affine holding its folded
    scale and shift.  Each is computed once, exactly as forward computes it
    on every call, so outputs are unchanged and a frame launches ~half as
    many kernels.  Every nn.GroupNorm becomes a ServingGroupNorm; where an
    nn.ReLU or nn.LeakyReLU follows it in an nn.Sequential, the activation
    is fused into it and its module becomes nn.Identity (the same values on
    the CPU; on CUDA the kernels round once where torch rounds after the
    norm and again after the activation).  Training never freezes, so its
    modules keep nn.GroupNorm and autograd.  Returns the module."""
    children = list(module.named_children())
    for i, (name, child) in enumerate(children):
        if isinstance(child, WSConv):
            conv = nn.Conv2d(child.in_channels, child.out_channels, child.kernel_size,
                             child.stride, child.padding, child.dilation,
                             bias=child.bias is not None, device=child.weight.device,
                             dtype=child.weight.dtype)
            conv.weight.copy_(child.standardized_weight())
            if child.bias is not None:
                conv.bias.copy_(child.bias)
            setattr(module, name, conv.requires_grad_(False))
        elif callable(getattr(child, "folded", None)):
            setattr(module, name, _Affine(*child.folded()))
        elif isinstance(child, nn.GroupNorm):
            nxt = children[i + 1] if i + 1 < len(children) else None
            act = (_activation(nxt[1])
                   if nxt is not None and isinstance(module, nn.Sequential) else None)
            setattr(module, name, ServingGroupNorm(child, *(act or ())))
            if act is not None:
                setattr(module, nxt[0], nn.Identity())
        else:
            freeze_for_inference(child)
    return module


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


# ---------------------------------------------------------------------------
# flax-default random init
# ---------------------------------------------------------------------------

_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


def _truncated_normal_(w: torch.Tensor, scale: float, generator: torch.Generator):
    """flax variance_scaling(scale, 'fan_in', 'truncated_normal') on OIHW."""
    fan_in = w[0].numel()
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    cdf = lambda v: 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))
    u = torch.empty(w.shape, dtype=torch.float64)
    u.uniform_(cdf(-2.0), cdf(2.0), generator=generator)
    x = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp_(-2.0, 2.0)
    with torch.no_grad():
        w.copy_((x * std).to(w.dtype))


@torch.no_grad()
def init_flax_style(module: nn.Module, generator: torch.Generator) -> None:
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            _truncated_normal_(m.weight, 2.0 if isinstance(m, WSConv) else 1.0, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
