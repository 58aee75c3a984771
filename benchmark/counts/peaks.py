"""The chip's published peaks (peaks.json), by the precision a cell
serves in: bf16 on the tensor cores, and fp32 against TF32's rate, since
the fp32 path's convolutions and 3xTF32 read run on the tensor cores."""
from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as f:
    PEAKS = json.load(f)


def peak_flops(dtype: str) -> float:
    """FLOP/s of one chip for a cell that computes in `dtype`."""
    return PEAKS["flops"]["bf16" if dtype == "bf16" else "tf32"]


def peak_bytes() -> float:
    return PEAKS["hbm_bytes_per_s"]
