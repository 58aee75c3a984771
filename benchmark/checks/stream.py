"""Whether a stream's outputs are right: the reference (fp32, TF32 off)
judges one served clip from the inputs the program had.

Random-weight streams at full width are chaotic: two exact programs part
after a few frames once a trimap's argmax flips a pixel near a tie.  So
no frame is judged after a chain of the reference's own frames.  The
served outputs are fed back instead (teacher forcing):

  joint (stage 4): every frame but the last, each memorized with the
    served alpha and trimap and the reference's own FBA hidden state (which
    the program does not return), from the memories of the earlier frames
    made so.  The bank the program held after the clip is then held slot by
    slot to the reference's memories of the same frames: slot 0, frame 0's,
    made eagerly before the bank holds anything (`first_slot_rel`), and the
    slots that the graph replays wrote, each after its frame's read,
    segment, FBA and bank update (`replay_slot_rel`, the worst of them);
  trimap (stage-1 STM): any frame exactly, from the memories of the frames
    its bank holds, each made with the served trimap of that frame.

A slot's reading is its relative difference (keys and values, the
larger)."""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..reference import stream as rs


def _frame(frames, i: int, device):
    return torch.from_numpy(rs.pad(frames[i])[None]).to(device, torch.float32)


def _mae(got: np.ndarray, want: torch.Tensor) -> float:
    return float(np.abs(got - want.float().cpu().numpy()).mean())


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def joint_judged(n: int) -> List[int]:
    """The frames whose served outputs check_joint reads: all but the last."""
    return list(range(n - 1))


@torch.no_grad()
def slot_rels(nets, frames, first_tri: np.ndarray, got: Dict[int, Tuple[np.ndarray, np.ndarray]],
              bank: Tuple[torch.Tensor, torch.Tensor], device) -> List[float]:
    """got[i] = (alpha [h, w], trimap [h, w, 3]) served for frame i, for
    every frame but the last; bank = the served bank's valid slots after
    the clip (keys [1, T, HW, Ck], values [1, T, HW, Cv]).  Each slot's
    relative difference from the reference's memory of its frame."""
    stm, fba = nets["stm"], nets["fba"]
    n, (h, w) = len(frames), frames[0].shape[:2]
    flags, max_num = rs.schedule(n, h, w)
    held = rs.slot_frames(flags, max_num, joint=True)[n - 1]
    if len(held) != bank[0].shape[1]:
        raise ValueError(f"the served bank holds {bank[0].shape[1]} slots; the protocol, "
                         f"{len(held)}")
    _, t0 = rs.pad(frames[0], first_tri)
    tri = torch.from_numpy(t0[None]).to(device, torch.float32)
    ref_bank, memories = rs.Bank(), {}
    for i in range(n - 1):                  # the last frame memorizes nothing
        first, memorize, last = flags[i]
        served = tuple(torch.from_numpy(x[None]).to(device) for x in got[i])
        forced = lambda a, t: (rs.repad(served[0][..., None], a), rs.repad(served[1], t))
        rs.joint_frame(stm, fba, ref_bank, _frame(frames, i, device), tri, first, memorize,
                       last, max_num, forced=forced)
        if i in held:
            memories[i] = ref_bank.slots[-1]
    return [max(_rel(bank[0][:, s].to(device), memories[j][0]),
                _rel(bank[1][:, s].to(device), memories[j][1])) for s, j in enumerate(held)]


def check_joint(nets, frames, first_tri: np.ndarray, got, bank, device) -> Dict[str, float]:
    """slot_rels' readings: slot 0's, and the worst of the replays' slots."""
    rels = slot_rels(nets, frames, first_tri, got, bank, device)
    return {"first_slot_rel": rels[0], "replay_slot_rel": max(rels[1:])}


@torch.no_grad()
def check_trimap(nets, frames, first_tri: np.ndarray, got: Dict[int, np.ndarray],
                 judged: Iterable[int], device) -> Dict[str, float]:
    """got[i] = the served trimap [h, w, 3] of frame i, for the frames
    judged and every frame their banks hold."""
    stm = nets["stm"]
    n, (h, w) = len(frames), frames[0].shape[:2]
    flags, max_num = rs.schedule(n, h, w)
    slots = rs.slot_frames(flags, max_num, joint=False)
    _, t0 = rs.pad(frames[0], first_tri)
    tri = torch.from_numpy(t0[None]).to(device, torch.float32)
    memories, err = {}, []

    def memory(i):
        if i not in memories:
            own = rs.pad(np.zeros((h, w, 3), np.float32), np.asarray(got[i]))[1]
            t = torch.from_numpy(own[None]).to(device)
            memories[i] = stm.memorize(_frame(frames, i, device), t[..., 1], t[..., 2])
        return memories[i]

    for j in sorted(set(judged)):
        if flags[j][0]:
            want = rs.unpad(tri, h, w)[0]
        else:
            bank = rs.Bank()
            bank.slots = [memory(i) for i in slots[j]]
            logits = stm.segment(_frame(frames, j, device), *bank.stacked())
            want = rs.unpad(torch.softmax(logits, dim=-1), h, w)[0]
        err.append(_mae(got[j], want))
    return {"trimap_mae": max(err)}


def trimap_frames_needed(n: int, h: int, w: int, judged: Iterable[int]):
    """The frames whose served trimaps check_trimap reads."""
    flags, max_num = rs.schedule(n, h, w)
    slots = rs.slot_frames(flags, max_num, joint=False)
    need = set(judged)
    for j in judged:
        need.update(slots[j])
    return sorted(need)
