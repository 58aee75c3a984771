"""PyTorch/CUDA port of otvm_tpu: joint OTVM streaming matting on an H100.

The JAX package `otvm_tpu` is the reference; this package imports nothing
from it (nor jax/flax) and keeps its own copy of every table and constant it
needs.  Modules mirror the JAX package's layout so each counterpart is easy
to find; inside, they are ordinary NCHW `nn.Module`s holding OIHW weights
under the original OTVM `state_dict` names.

Numerics: the fp32 path runs with TF32 off for both matmuls and cuDNN
convolutions (`set_fp32_numerics`), so fp32 results are comparable with the
JAX reference.  bf16 serving is a separate mode with its own drift bound.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another one.  Without a CUDA device, CUDA (asked for or by default)
    raises: the port never falls back to the CPU on its own."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    return device


def set_fp32_numerics() -> None:
    """Full-precision fp32 on the card: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
