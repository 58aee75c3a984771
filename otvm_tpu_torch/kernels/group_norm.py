"""GroupNorm of frozen serving models: the hand-written CUDA kernels, their
plain PyTorch version, and the wrapper that picks between them.

The kernels (csrc/group_norm.cu) replace no TPU kernel: the JAX package's
GroupNorm is plain XLA.  They replace torch's CUDA GroupNorm on the serving
path, whose statistics kernel runs one block per (sample, group): 32
blocks at batch 1.  A statistics pass cuts each group into chunks so that
the grid fills the card and writes a partial (count, mean, M2) a chunk; an
apply pass merges the group's partials (Chan's formula, in a fixed order)
and writes the normalised, scaled and shifted values with the activation
that follows the norm fused (none, ReLU or LeakyReLU), rounded once.  The
source note gives the bound (bytes: 3 x elements x dtype size) and the
design.  The library is compiled like the memory read's
(memory_attn.compile_library: nvcc for sm_90a, a plain C entry, ctypes,
cached by content in build/) on first use, which must be an eager call:
nothing is built inside a CUDA-graph capture.

`group_norm` takes the plain version for tensors on the CPU and the
kernels for CUDA tensors; on CUDA it launches them or raises, and never
falls back.  It has no gradient: training keeps nn.GroupNorm
(nn/layers.py freeze_for_inference swaps the norms of serving models
only).  `launches` counts group norms launched on the card (each one
statistics and one apply kernel); inside a capture they are recorded
(`record_launches`) and each replay counts them (`count_launches`), as the
memory read's are.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from pathlib import Path
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import memory_attn as ma

_SRC = Path(__file__).resolve().parent / "csrc" / "group_norm.cu"
ACTS = {None: 0, "relu": 1, "leaky_relu": 2}    # the activation fused after the norm
THREADS = 256                   # a block's threads (csrc/group_norm.cu)
# Blocks the grid aims at per SM (the card holds 8 of 256 threads an SM):
# tools/bench_group_norm.py --sweep 2,3,6,8,16,32 on an H100 timed a
# stage-4 frame's 66 bf16 norms at 1088x1920 in 4.74 ms at 4, 5.19 at 2,
# 4.90 at 3, 5.19 at 6, 5.07 at 8, 5.43 at 16 and 6.14 at 32 (PERF.md).
BLOCKS_PER_SM = 4
_MAX_GROUPS = 65535             # N * G: the grid's second axis

launches = 0                    # group norms launched on the card since the last reset
_recorded: Optional[List[int]] = None   # group norms of the capture in progress
_lib: Optional[ctypes.CDLL] = None
build_log = ""                  # nvcc's output (registers, spills)
library_path: Optional[Path] = None


def build() -> ctypes.CDLL:
    """Compile (once per source and flags) and load the kernel library;
    `build_log` has ptxas's report.  Raises inside a CUDA-graph capture."""
    global _lib, build_log, library_path
    if _lib is not None:
        return _lib
    ma._not_capturing("building the group-norm library")
    so, build_log = ma.compile_library(_SRC)
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.otvm_group_norm.argtypes = ([i32] + [ptr] * 5 + [i32] * 3 + [i64] * 2
                                    + [i32, f32, i32, f32, ptr])
    lib.otvm_group_norm.restype = i32
    _lib, library_path = lib, so
    return lib


def chunking(groups_total: int, group_len: int, dtype: torch.dtype, sms: int
             ) -> Tuple[int, int]:
    """(chunk, chunks): each of the `groups_total` groups of `group_len`
    values is cut into `chunks` chunks of `chunk` values, a multiple of one
    16-byte load for each of a block's threads, so that the grid (chunks,
    groups_total) holds at least BLOCKS_PER_SM blocks an SM of a card with
    `sms` SMs where the groups are long enough (fewer, of one such load
    each, where they are not)."""
    step = THREADS * (16 // dtype.itemsize)
    per_group = -(-BLOCKS_PER_SM * sms // groups_total)
    chunk = max(step, -(-group_len // per_group) // step * step)
    return chunk, -(-group_len // chunk)


def group_norm_plain(x: torch.Tensor, num_groups: int, weight: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
                     act: Optional[str] = None, slope: float = 0.01) -> torch.Tensor:
    """F.group_norm, then the activation as the unfrozen model applies it
    (nn.ReLU, nn.LeakyReLU(slope))."""
    y = F.group_norm(x, num_groups, weight, bias, eps)
    if act == "relu":
        return F.relu(y)
    if act == "leaky_relu":
        return F.leaky_relu(y, slope)
    return y


def _check_args(x: torch.Tensor, num_groups: int, act: Optional[str]) -> None:
    if x.dim() < 2 or x.shape[1] % num_groups:
        raise ValueError(f"group_norm: {num_groups} groups do not divide the channels of "
                         f"{tuple(x.shape)}")
    if act not in ACTS:
        raise ValueError(f"group_norm: unknown activation {act!r} (want one of {list(ACTS)})")


@contextlib.contextmanager
def record_launches():
    """Around a CUDA-graph capture: the group norms captured inside launch
    nothing now, so they are recorded in the list this yields, not counted;
    each replay of the graph passes it to `count_launches`.  A group norm
    captured outside this context raises, as its replays would go
    uncounted."""
    global _recorded
    if _recorded is not None:
        raise RuntimeError("record_launches does not nest")
    _recorded = norms = []
    try:
        yield norms
    finally:
        _recorded = None


def count_launches(norms: List[int]) -> None:
    """Counts group norms launched on the card: one by the wrapper's eager
    launch, or those a graph's capture recorded, at each replay."""
    global launches
    launches += len(norms)


@ma._on_own_card
def group_norm_cuda(x: torch.Tensor, num_groups: int, weight: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
                    act: Optional[str] = None, slope: float = 0.01) -> torch.Tensor:
    """The kernels on x's card: statistics then apply, two launches on the
    current stream.  x [N, C, *] NCHW-contiguous, bf16 or fp32; weight and
    bias [C] in x's dtype, or None.  No gradient.  Inside a CUDA-graph
    capture the launch is recorded (`record_launches`), not counted.
    Raises on what it does not take; never falls back."""
    if not x.is_cuda:
        raise ValueError("group_norm_cuda needs a CUDA tensor")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm_cuda: dtype {x.dtype} not supported (bf16 or fp32)")
    _check_args(x, num_groups, act)
    if not x.is_contiguous():
        raise ValueError("group_norm_cuda: x must be NCHW-contiguous (not channels_last or a "
                         "strided view)")
    c = x.shape[1]
    for name, p in (("weight", weight), ("bias", bias)):
        if p is not None and not (p.device == x.device and p.dtype == x.dtype
                                  and tuple(p.shape) == (c,) and p.is_contiguous()):
            raise ValueError(f"group_norm_cuda: {name} must be [{c}], contiguous, on x's card "
                             f"in {x.dtype}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias)):
        raise RuntimeError("group_norm_cuda gives no gradient: training keeps nn.GroupNorm")
    n = x.shape[0]
    hw = math.prod(x.shape[2:])
    groups_total, group_len = n * num_groups, (c // num_groups) * hw
    if not 1 <= groups_total <= _MAX_GROUPS or group_len >= 1 << 31:
        raise ValueError(f"group_norm_cuda: {groups_total} groups of {group_len} values (want "
                         f"1..{_MAX_GROUPS} groups of fewer than 2^31)")
    capturing = torch.cuda.is_current_stream_capturing()
    if capturing and _recorded is None:
        raise RuntimeError("group_norm_cuda captured in a CUDA graph outside record_launches(): "
                           "its replays would launch group norms that no count sees")
    lib = build()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunk, chunks = chunking(groups_total, group_len, x.dtype, sms)
    part = torch.empty(3 * groups_total * chunks, dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    ma._check(lib.otvm_group_norm(int(x.dtype == torch.bfloat16), x.data_ptr(), ptr(weight),
                                  ptr(bias), y.data_ptr(), part.data_ptr(), groups_total,
                                  num_groups, c // num_groups, hw, chunk, chunks, eps, ACTS[act],
                                  slope, ma._stream(x)),
              "group_norm kernel launch")
    if capturing:
        _recorded.append(1)
    else:
        count_launches([1])
    return y


def group_norm(x: torch.Tensor, num_groups: int, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
               act: Optional[str] = None, slope: float = 0.01) -> torch.Tensor:
    """GroupNorm with the activation `act` after it: the kernels for a CUDA
    tensor, the plain version for a CPU tensor.  Raises where the groups
    do not divide the channels, and on CUDA on whatever the kernels do not
    take."""
    if x.is_cuda:
        return group_norm_cuda(x, num_groups, weight, bias, eps, act, slope)
    _check_args(x, num_groups, act)
    return group_norm_plain(x, num_groups, weight, bias, eps, act, slope)
