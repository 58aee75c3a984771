"""Seeded weights for both sides of a check: one state_dict, drawn on the
device in one call, that the program and the reference both load.

Every value comes from one standard normal vector, clipped to [-2, 2]
(flax's truncated range), then scaled per leaf in one fused step:
convolutions at flax's fan-in scale (lecun for plain, he for
weight-standardized ones), norm scales 1 + z/10 (a tenth of that for the
norm that closes a residual branch), norm and conv biases and
BN running means z/10, BN running variances 1 + z/5.  Leaves that keep the
published value whatever the training did (the trunks' ImageNet mean and
std, BN's step counter) keep it.  Statistics away from 0 and 1 make a
folded or swapped norm show in the outputs."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn

from .nets import IMAGENET_MEAN, IMAGENET_STD, WSConv

_TRUNC_STD = 0.87962566103423978     # std of a standard normal truncated to [-2, 2]


# the norm that closes a residual branch starts its scale at a tenth (as
# torchvision's zero_init_residual and Goyal et al. 2017 start it at 0): at
# scale 1 the random trunks are chaotic, and a bf16 and an fp8 run part from
# fp32 alike (PERF.md)
RESIDUAL_GAMMA = 0.1


def _leaf_law(modules: Dict[str, nn.Module], name: str, shape) -> tuple:
    """(mul, add) of the leaf `name`: value = add + mul * z."""
    owner, _, leaf = name.rpartition(".")
    last = owner.rpartition(".")[2]
    if leaf == "weight" and (last == "bn3" or (owner.startswith("refine.layer") and last == "bn2")):
        return 0.1 * RESIDUAL_GAMMA, RESIDUAL_GAMMA
    mod = modules[owner]
    if isinstance(mod, nn.Conv2d) and leaf == "weight":
        scale = 2.0 if isinstance(mod, WSConv) else 1.0
        return math.sqrt(scale / math.prod(shape[1:])) / _TRUNC_STD, 0.0
    if leaf == "running_var":
        return 0.2, 1.0
    if leaf == "weight":
        return 0.1, 1.0
    return 0.1, 0.0                                     # biases, running means


def seeded_state(model: nn.Module, seed: int, device, dtype=torch.float32
                 ) -> Dict[str, torch.Tensor]:
    """A state_dict for `model` (any device, meta included) drawn from
    `seed` on `device`."""
    modules = dict(model.named_modules())
    drawn, fixed = [], {}
    for name, t in model.state_dict(keep_vars=True).items():
        leaf = name.rpartition(".")[2]
        if not t.is_floating_point():
            fixed[name] = torch.zeros(t.shape, dtype=t.dtype, device=device)
        elif leaf in ("mean", "std") and tuple(t.shape) == (1, 3, 1, 1):
            fixed[name] = torch.tensor(IMAGENET_MEAN if leaf == "mean" else IMAGENET_STD,
                                       device=device, dtype=dtype).view(1, 3, 1, 1)
        else:
            drawn.append((name, tuple(t.shape)))
    sizes = [math.prod(s) for _, s in drawn]
    laws = torch.tensor([_leaf_law(modules, n, s) for n, s in drawn], dtype=torch.float32,
                        device=device)
    counts = torch.tensor(sizes, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32).clamp_(-2, 2)
    flat = torch.addcmul(laws[:, 1].repeat_interleave(counts), laws[:, 0].repeat_interleave(counts),
                         z).to(dtype)
    state = dict(fixed)
    for (name, shape), part in zip(drawn, torch.split(flat, sizes)):
        state[name] = part.view(shape)
    return state
