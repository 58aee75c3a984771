"""Epoch order and the uint8 wire format of training batches, counterpart
of otvm_tpu/data/loader.py (`epoch_indices`, `encode_wire`, `decode_wire`).

A train batch is a dict of [B, S, H, W, C] arrays (fg, bg, alpha, tri;
img for the trimap stage).  `encode_wire` quantizes it on the host to
uint8, the precision its 8-bit sources had: fg, bg and alpha as bytes, the
one-hot trimap as its label.  `decode_wire` restores the floats on the
device, inside the train step.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F


def epoch_indices(n_items: int, epoch: int, repeats: int = 20, seed: int = 111,
                  process_index: int = 0, process_count: int = 1) -> np.ndarray:
    """The dataset repeated `repeats` times, shuffled by a per-epoch seed
    that every process shares, padded to a multiple of `process_count`
    (DistributedSampler semantics, train.py:283-304, 475-480) and strided
    by `process_index`."""
    idx = np.tile(np.arange(n_items), repeats)
    rng = np.random.RandomState(seed + epoch)
    rng.shuffle(idx)
    pad = (-len(idx)) % process_count
    if pad:
        idx = np.concatenate([idx, idx[:pad]])
    return idx[process_index::process_count]


def encode_wire(sample: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """fg, bg and alpha as uint8 (rounded), the one-hot trimap as its uint8
    label; other entries unchanged.  The error is at most 0.5/255 on values
    whose sources were 8-bit."""
    out = {}
    for k, v in sample.items():
        if k in ("fg", "bg", "alpha"):
            out[k] = np.rint(v * 255.0).astype(np.uint8)
        elif k == "tri":
            out[k] = np.argmax(v, axis=-1).astype(np.uint8)
        else:
            out[k] = v
    return out


def decode_wire(batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """encode_wire's inverse on the batch's device; float entries pass
    unchanged."""
    out = dict(batch)
    for k in ("fg", "bg", "alpha"):
        if k in out and out[k].dtype == torch.uint8:
            out[k] = out[k].float() / 255.0
    if "tri" in out and out["tri"].dtype == torch.uint8:
        out["tri"] = F.one_hot(out["tri"].long(), 3).float()
    return out
