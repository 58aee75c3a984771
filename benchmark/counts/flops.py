"""FLOPs of the cells' work, counted by torch.utils.flop_counter over the
reference networks (reference/nets.py) on the meta device at a cell's
shapes: the convolutions and matrix products, the same work whatever
implements it.  Each stream frame is counted in parts, the memory read
left out of `segment` (its two products are added per frame by
counts/read.py over the slots that frame reads)."""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import nets
from ..reference.edt import trimap_features
from ..reference.train import joint_loss


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _no_read(q, keys, values, quant=None):
    return torch.zeros(q.shape[:2] + values.shape[-1:], dtype=q.dtype, device=q.device)


def stream_parts(network: str, height: int, width: int, scale: int = 1) -> Dict[str, int]:
    """One frame's parts at a padded height x width, batch 1:
    `segment` without its read, `memorize`, and (joint) `fba` with the
    trimap features; a frame with T valid slots costs segment + the read
    at T (not on the first frame) + fba + memorize (not on a joint
    stream's last frame)."""
    m = nets.build(network, scale)
    for net in m.values():
        net.to("meta")
    stm = m["stm"]
    stm.read = _no_read
    meta = dict(device="meta", dtype=torch.float32)
    frame = torch.zeros(1, height, width, 3, **meta)
    plane = torch.zeros(1, height, width, **meta)
    t = (height // 16) * (width // 16)
    keys = torch.zeros(1, 1, t, stm.key_dim, **meta)
    values = torch.zeros(1, 1, t, stm.val_dim, **meta)
    out = {"segment": _count(lambda: stm.segment(frame, keys, values))}
    if network == "joint":
        hid = torch.zeros(1, height, width, 16, **meta)
        out["memorize"] = _count(lambda: stm.memorize(frame, plane, plane, alpha=plane,
                                                      hidden=hid))

        def fba():
            feats, _ = trimap_features(torch.zeros(1, height, width, 3, **meta))
            m["fba"](torch.zeros(1, height, width, 11, **meta), frame, feats[..., -2:])
        out["fba"] = _count(fba)
    else:
        out["memorize"] = _count(lambda: stm.memorize(frame, plane, plane))
    return out


def train_step_flops(batch: int, frames: int, height: int, width: int, scale: int = 1) -> int:
    """The stage-4 loss's forward and backward over a batch of `batch`
    clips of `frames` frames (its memory reads included: every slot of a
    training read is valid)."""
    m = nets.build("joint", scale)
    for net in m.values():
        net.to("meta")
    meta = dict(device="meta")
    shape = (batch, frames, height, width)
    b = {"fg": torch.zeros(*shape, 3, **meta), "bg": torch.zeros(*shape, 3, **meta),
         "alpha": torch.zeros(*shape, 1, **meta),
         "tri": torch.zeros(*shape, 3, **meta)}

    def step():
        loss, _ = joint_loss(m["stm"], m["fba"], b)
        loss.backward()
    return _count(step)
