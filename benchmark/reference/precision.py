"""The precision below the one a configuration states, for the checks'
controls: the reference computed there in the program's place must come
out not correct.

fp8 below bf16, as fp8 training and serving run it (Micikevicius et al.,
"FP8 Formats for Deep Learning", 2022): every convolution's and the
memory read's operands rounded to e4m3 and, in the backward pass, the
gradient reaching each convolution's output rounded to e5m2, each tensor
with one scale from its largest magnitude; the rest computes in bf16.
TF32 below fp32 with TF32 off."""
from __future__ import annotations

import contextlib

import torch

from .nets import QConv

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, fmt: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(fmt).float() * scale).to(x.dtype)


class _Operand(torch.autograd.Function):
    """Forward: x rounded to e4m3.  Backward: the gradient passes."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _OutputGrad(torch.autograd.Function):
    """Forward: y as it is.  Backward: y's gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class FP8:
    """The rounding a QConv (and the read) applies when `quant` is set."""

    @staticmethod
    def operand(x: torch.Tensor) -> torch.Tensor:
        return _Operand.apply(x)

    @staticmethod
    def output(y: torch.Tensor) -> torch.Tensor:
        return _OutputGrad.apply(y)


def set_quant(nets, quant) -> None:
    """Every convolution and memory read of the reference `nets` (a dict
    of modules) rounds as `quant` says (None: not at all)."""
    for net in nets.values():
        for m in net.modules():
            if isinstance(m, QConv) or hasattr(m, "read"):
                m.quant = quant


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for fp32 matmuls and convolutions inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
