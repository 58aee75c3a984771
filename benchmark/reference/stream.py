"""The reference's streaming inference (eval.py:117-242 with
models/alpha/model.py:391-512 and models/trimap/model.py:173-281): the
protocol's schedule, the memory bank's policy and one frame of the joint
and of the trimap-only stream, in plain PyTorch on `nets.py`.

`forced` lets a check feed the served stream's own outputs into the
memory (teacher forcing), so one frame is judged from the inputs the
program had, not after a chain of earlier frames in which rounding has
grown.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .edt import trimap_features
from .nets import normalize_image


def schedule(n: int, height: int, width: int, skip: int = 10, max_num: int = 5,
             large_edge: int = 1100) -> Tuple[List[Tuple[bool, bool, bool]], int]:
    """Per-frame (first, memorize, last) and the bank's size: inputs whose
    short edge is above `large_edge` memorize half as often into half the
    bank (eval.py:184-188)."""
    if min(height, width) > large_edge:
        skip, max_num = skip * 2, int(max_num / 2)
    flags = [(i == 0, (i % skip == 0) if skip > 2 else False, i == n - 1) for i in range(n)]
    return flags, max_num


class Bank:
    """Slots as a list, updated by the reference's policy: the first frame
    resets; a memorized frame appends, any other replaces the last slot
    (or appends after the first frame alone); past `max_num` slot 1 goes,
    keeping the first frame's (slot 0 without keep_first)."""

    def __init__(self):
        self.slots: list = []

    def update(self, item, first: bool, memorize: bool, max_num: int, keep_first: bool = True):
        if max_num == 1 or first:
            self.slots = [item]
            return
        if max_num <= 0:
            return
        if memorize or len(self.slots) == 1:
            self.slots.append(item)
        else:
            self.slots[-1] = item
        if len(self.slots) > max_num:
            del self.slots[1 if keep_first else 0]

    def stacked(self):
        return (torch.stack([k for k, _ in self.slots], dim=1),
                torch.stack([v for _, v in self.slots], dim=1))


def slot_frames(flags, max_num: int, joint: bool) -> List[List[int]]:
    """For each frame, the frames whose memories the bank holds when it is
    segmented.  The joint step memorizes every frame but the last; the
    trimap step every frame."""
    bank, out = Bank(), []
    for i, (first, memorize, last) in enumerate(flags):
        out.append(list(bank.slots))
        if not (joint and last):
            bank.update(i, first, memorize and not last, max_num)
    return out


def pad_amounts(h: int, w: int, d: int = 32):
    """(lw, uw, lh, uh): to multiples of d, split about the centre."""
    nh, nw = h + (d - h % d) % d, w + (d - w % d) % d
    return ((nw - w) // 2, (nw - w) - (nw - w) // 2, (nh - h) // 2, (nh - h) - (nh - h) // 2)


def pad(frame: np.ndarray, tri: Optional[np.ndarray] = None, d: int = 32):
    """A frame zero-padded and a trimap bg-padded to multiples of d."""
    lw, uw, lh, uh = pad_amounts(*frame.shape[:2], d)
    p = ((lh, uh), (lw, uw))
    f = np.pad(frame, (*p, (0, 0)))
    if tri is None:
        return f
    return f, np.stack([np.pad(tri[..., 0], p, constant_values=1.0), np.pad(tri[..., 1], p),
                        np.pad(tri[..., 2], p)], axis=-1)


def unpad(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H', W', ...] padded by `pad` -> [B, h, w, ...]."""
    lw, uw, lh, uh = pad_amounts(h, w)
    return x[:, lh:lh + h, lw:lw + w]


def repad(inner: torch.Tensor, own: torch.Tensor) -> torch.Tensor:
    """`own` [B, H', W', ...] with its centre replaced by `inner` [B, h, w, ...]."""
    h, w = inner.shape[1:3]
    lw, uw, lh, uh = pad_amounts(h, w)
    out = own.clone()
    out[:, lh:lh + h, lw:lw + w] = inner.to(own.dtype)
    return out


def joint_frame(stm, fba, bank: Bank, frame, first_tri, first: bool, memorize: bool,
                last: bool, max_num: int, forced: Optional[Callable] = None):
    """One frame of the joint stream: segment over the bank (the given
    trimap on the first frame), the trimap's clicks, FBA with refinement,
    then memorize the frame with alpha, the refined trimap and FBA's hidden
    state.  forced: (own alpha [B, H, W, 1], own trimap [B, H, W, 3]) ->
    the pair to memorize instead.  Returns (alpha, refined trimap), NHWC."""
    if first:
        tri3 = first_tri
    else:
        tri3 = torch.softmax(stm.segment(frame, *bank.stacked()), dim=-1)
    feats8, _ = trimap_features(tri3)
    x11 = torch.cat([normalize_image(frame), feats8], dim=-1)
    _, hid, refined, logits = fba(x11, frame, feats8[..., -2:])
    alpha, out_tri = refined[..., 0:1], torch.softmax(logits, dim=-1)
    if not last:
        a, t = forced(alpha, out_tri) if forced is not None else (alpha, out_tri)
        k, v = stm.memorize(frame, t[..., 1], t[..., 2], alpha=a[..., 0], hidden=hid)
        bank.update((k, v), first, memorize, max_num)
    return alpha, out_tri


def trimap_frame(stm, bank: Bank, frame, first_tri, first: bool, memorize: bool, max_num: int):
    """One frame of trimap propagation alone: the given trimap on the
    first frame, else segment and softmax; then memorize the frame with
    its trimap.  Returns the trimap [B, H, W, 3]."""
    if first:
        pred = first_tri
    else:
        pred = torch.softmax(stm.segment(frame, *bank.stacked()), dim=-1)
    bank.update(stm.memorize(frame, pred[..., 1], pred[..., 2]), first, memorize, max_num)
    return pred


def run_clip(nets, frames: Sequence[np.ndarray], first_tri: np.ndarray, device, dtype,
             joint: bool):
    """A whole clip through the reference stream, its own outputs fed
    back: (alphas or None, trimaps) unpadded, fp32 numpy, and the bank
    after it.  The checks' control serves in the program's place with it."""
    h, w = frames[0].shape[:2]
    flags, max_num = schedule(len(frames), h, w)
    f0, t0 = pad(frames[0], first_tri)
    tri = torch.from_numpy(t0[None]).to(device, dtype)
    bank, alphas, trimaps = Bank(), [], []
    with torch.no_grad():
        for i, (first, memorize, last) in enumerate(flags):
            f = torch.from_numpy((f0 if i == 0 else pad(frames[i]))[None]).to(device, dtype)
            if joint:
                a, t = joint_frame(nets["stm"], nets["fba"], bank, f, tri, first, memorize, last,
                                   max_num)
                alphas.append(unpad(a, h, w)[0, ..., 0].float().cpu().numpy())
            else:
                t = trimap_frame(nets["stm"], bank, f, tri, first, memorize, max_num)
            trimaps.append(unpad(t, h, w)[0].float().cpu().numpy())
    return (alphas if joint else None), trimaps, bank
