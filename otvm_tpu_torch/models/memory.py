"""Fixed-capacity space-time memory bank, counterpart of
otvm_tpu/models/memory.py.

The bank holds [B, CAP, HW, C] keys and values plus `count`, the number of
valid slots, a host int.  Flags are Python bools, so no update waits for the
device.  Updates write slots and shift them left IN PLACE on the bank's
tensors (the JAX version builds new arrays); the returned bank shares them.

Reference policy (models/alpha/model.py:472-493, trimap/model.py:193-225):
  * first_frame                  -> bank = {new}, count = 1
  * max_num == 0                 -> keep the first-frame memory forever
  * max_num == 1                 -> bank = {new}
  * else: memorize -> append; otherwise replace the last (rolling) slot, or
    append if the bank holds only the first frame; on overflow
    (count > max_num) evict slot 1, keeping slot 0 = the ground-truth first
    frame (slot 0 when keep_first=False, the memorize_gt trimap eval).
"""
from __future__ import annotations

import dataclasses

import torch

from .stm import KEY_DIM, VAL_DIM


@dataclasses.dataclass
class MemoryBank:
    keys: torch.Tensor     # [B, CAP, HW, Ck]
    values: torch.Tensor   # [B, CAP, HW, Cv]
    count: int             # number of valid slots

    @property
    def slot_mask(self) -> torch.Tensor:
        """[B, CAP] bool, True for valid slots."""
        b, cap = self.keys.shape[:2]
        m = torch.arange(cap, device=self.keys.device) < self.count
        return m[None, :].expand(b, cap)


def init_bank(batch: int, hw: int, max_memory_num: int, dtype=torch.float32,
              key_dim: int = KEY_DIM, val_dim: int = VAL_DIM,
              device=None) -> MemoryBank:
    """Capacity max(max_memory_num, 1) + 1: one transient slot for the
    reference's append-then-evict on overflow."""
    cap = max(max_memory_num, 1) + 1
    return MemoryBank(
        keys=torch.zeros((batch, cap, hw, key_dim), dtype=dtype, device=device),
        values=torch.zeros((batch, cap, hw, val_dim), dtype=dtype, device=device),
        count=0)


def _reset(bank: MemoryBank, new_k: torch.Tensor, new_v: torch.Tensor) -> MemoryBank:
    bank.keys.zero_()
    bank.values.zero_()
    bank.keys[:, 0] = new_k
    bank.values[:, 0] = new_v
    return MemoryBank(bank.keys, bank.values, 1)


def _drop_slot(arr: torch.Tensor, slot: int) -> None:
    """Remove `slot`, shifting later slots left; the stale last slot is
    masked out by count."""
    arr[:, slot:-1] = arr[:, slot + 1:].clone()


def update_bank(bank: MemoryBank, new_k: torch.Tensor, new_v: torch.Tensor,
                first_frame: bool, memorize: bool, max_memory_num: int,
                keep_first: bool = True) -> MemoryBank:
    """One streaming-eval bank update (in place).  new_k [B, HW, Ck],
    new_v [B, HW, Cv]."""
    if max_memory_num == 1 or first_frame:
        return _reset(bank, new_k, new_v)
    if max_memory_num <= 0:
        return bank
    append = memorize or bank.count == 1
    idx = bank.count if append else bank.count - 1
    count = bank.count + 1 if append else bank.count
    bank.keys[:, idx] = new_k
    bank.values[:, idx] = new_v
    if count > max_memory_num:
        slot = 1 if keep_first else 0
        _drop_slot(bank.keys, slot)
        _drop_slot(bank.values, slot)
        count -= 1
    return MemoryBank(bank.keys, bank.values, count)
