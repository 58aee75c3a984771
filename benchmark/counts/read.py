"""Operations and bytes of one memory read: q [B, HW, Ck] attending over
T valid slots of keys [B, T, HW, Ck] and values [B, T, HW, Cv], the
output [B, HW, Cv].  Two products, each 2 * B * HW * (T * HW) * C; every
input byte read once and the output written once, in the read's dtype.
The bank's padded slots are not work the algorithm needs."""
from __future__ import annotations

from . import peaks


def read_ops(b: int, hw: int, t_valid: int, ck: int, cv: int) -> float:
    return 2.0 * b * hw * (t_valid * hw) * (ck + cv)


def read_bytes(b: int, hw: int, t_valid: int, ck: int, cv: int, itemsize: int) -> float:
    return float(itemsize) * b * hw * (ck + t_valid * ck + t_valid * cv + cv)


def read_least_s(b: int, hw: int, t_valid: int, ck: int, cv: int, dtype: str) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory's bandwidth."""
    itemsize = 2 if dtype == "bf16" else 4
    return max(read_ops(b, hw, t_valid, ck, cv) / peaks.peak_flops(dtype),
               read_bytes(b, hw, t_valid, ck, cv, itemsize) / peaks.peak_bytes())
