"""Space-time memory read: the hand-written CUDA kernels, their plain PyTorch
versions, and the wrappers that pick between them.

The kernels (csrc/memory_attn.cu) replace
otvm_tpu/kernels/memory_attn.py::memory_read_pallas; the source note gives
the bound on an H100, the design and the times on the card.  Both dtypes
run on wgmma, with K/V tiles brought in by TMA: bf16 directly, fp32 in
3xTF32 (each operand split into two TF32 halves, three products per
product: fp32's accuracy), with a warpgroup of its own for S and each K,
V and p value split once.  Where the grid alone would leave the card
idle, the live K/V tiles are split across up to 8 blocks per output
tile, which merge their partial results in the same launch: as one
thread-block cluster a tile, through each other's shared memory, where
the card holds those clusters in one wave; else through a workspace in
L2, after a barrier of the tile's blocks, in a cooperative launch (all
its blocks resident at once, whatever else the card runs).  The library
is compiled with nvcc for sm_90a, with a plain C entry, on first use,
into build/ at the root of the checkout, and loaded with ctypes.

`memory_read` takes the plain version for tensors on the CPU and the
kernels for CUDA tensors; on CUDA it launches them or raises, and never
falls back.  Where an input requires grad (training), it goes through
`MemoryRead`, an autograd Function: the same forward, and as backward
`memory_read_vjp_plain`, the einsum VJP of the JAX package's custom VJP
(`_flash_bwd`; the JAX package has no backward kernel either).  `launches`
counts memory-read kernel launches and `cluster_launches` those of them
that were split over clusters (and nothing else), `l2_merge_launches`
those split and merged through L2, so a run can show that
its main path went through them.  A read captured in a CUDA graph launches
nothing at its capture: it is recorded (`record_launches`), and each replay
counts what its capture recorded (`count_launches`).  Nothing lazy happens
inside a capture: the library, the card's cluster table and the L2
workspace are made by an eager read on the capture stream first, and a
capture that would make one raises.  `memory_read_tf32_plain` emulates the
fp32 kernel's tensor-core arithmetic on any device.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_SRC = Path(__file__).resolve().parent / "csrc" / "memory_attn.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_KEY_DIMS = (32, 128)   # the real model and the scale=4 test model
_CV_SLICE = 128
_MAX_SLOTS = 256
BQ = 128                # query rows per block of the bf16 kernel
F_BQ = 64               # query rows per block of the fp32 kernel
BK = 64                 # positions per K/V tile of the bf16 kernel
F_BK = 32               # positions per K/V tile of the fp32 kernel
_MAX_SPLITS = 8         # blocks of an output tile; of a cluster, the portable size
# The split rule gives each split at least this many of its dtype's K/V
# tiles: the sweep of tools/bench_memory_read.py on an H100 found no shape
# where 2 tiles a split lose to fewer splits (the training shapes' bf16 T=1
# read, 7 tiles, is fastest at 3 splits; PERF.md).
MIN_TILES_PER_SPLIT = 2
# At equal split counts the cluster merge beats the L2 merge at the
# training shapes; the rule takes the L2 merge's larger split count over
# the largest one-cluster count only where it cuts at least this many of
# the dtype's K/V tiles off the longest split (the same sweep).
L2_MERGE_TILES = {torch.bfloat16: 2, torch.float32: 1}

launches = 0            # memory-read kernel launches since the last reset
cluster_launches = 0    # of them, split launches merged in a cluster
l2_merge_launches = 0   # of them, split launches merged through L2
# Checks that hold every read to the plain read on the host while they are
# active (tools/kernel_check.lockstep_check): a graph replay, whose reads
# the host never sees, must refuse to run under one.
host_checks = 0
_recorded: Optional[List[Tuple[int, int]]] = None   # reads of the capture in progress
_lib: Optional[ctypes.CDLL] = None
build_log = ""          # nvcc's output (registers, shared memory, spills)
library_path: Optional[Path] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: the memory-read kernel cannot be built")


def compile_library(src_path: Path) -> Tuple[Path, str]:
    """nvcc `src_path` with NVCC_FLAGS into build/<stem>_<hash>.so, once per
    source and flags -> (the library, nvcc's output).  The output is kept
    beside the library as .log, so a later call that finds the library
    built still has ptxas's report."""
    src = src_path.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"{src_path.stem}_{tag}.so"
    log = so.with_suffix(".log")
    if not (so.exists() and log.exists()):
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src_path)],
                                  capture_output=True, text=True)
            out = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}")
            log.write_text(out)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so, log.read_text()


def build() -> ctypes.CDLL:
    """Compile (once per source and flags) and load the kernel library;
    `build_log` has ptxas's report."""
    global _lib, build_log, library_path
    if _lib is not None:
        return _lib
    _not_capturing("building the kernel library")
    so, build_log = compile_library(_SRC)
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.otvm_memory_read_f32.argtypes = [ptr] * 5 + [i32] * 7 + [ptr] * 3
    lib.otvm_memory_read_bf16.argtypes = [ptr] * 5 + [i32] * 7 + [ptr] * 3
    lib.otvm_memory_read_max_clusters.argtypes = [i32] * 4 + [ctypes.POINTER(i32)]
    for fn in (lib.otvm_memory_read_f32, lib.otvm_memory_read_bf16,
               lib.otvm_memory_read_max_clusters):
        fn.restype = i32
    _lib, library_path = lib, so
    return lib


# ---------------------------------------------------------------------------
# launch geometry of the kernels (both dtypes)
# ---------------------------------------------------------------------------

def value_tile(cv: int) -> int:
    """Value columns per block: 256, or 128 where Cv is not a multiple of 256."""
    return 256 if cv % 256 == 0 else 128


def query_tile(dtype: torch.dtype) -> int:
    """Query rows per block of the kernel for `dtype` (bf16 128, fp32 64)."""
    return BQ if dtype == torch.bfloat16 else F_BQ


def tile_positions(dtype: torch.dtype) -> int:
    """Memory positions per K/V tile of the kernel for `dtype` (bf16 64,
    fp32 32): the split rule's unit."""
    return BK if dtype == torch.bfloat16 else F_BK


def launch_geometry(b: int, hw: int, t: int, cv: int, dtype: torch.dtype,
                    max_clusters: Mapping[int, int], _splits: Optional[int] = None,
                    _cluster: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(query tiles, value tiles, splits, blocks) of one launch of the
    kernel for `dtype`: each output tile (query tile, value tile, batch
    row) is read by `splits` blocks, merged inside the kernel: as one
    cluster a tile (blocks = splits), or without clusters through L2
    (blocks = 1), which needs the grid's tiles x splits blocks on the card
    at once (the kernel launches it cooperatively: where another stream's
    kernels hold SMs, it waits until the whole grid is resident).
    `max_clusters` is the card's figure for this kernel
    (`max_active_clusters`): {n: clusters of n blocks it holds at once; 1:
    blocks}.  The split count is the largest up to 8 that gives each split
    at least MIN_TILES_PER_SPLIT of the dtype's K/V tiles of the bank and
    whose grid the card holds at once, merged in one cluster a tile where
    the card holds the tiles' clusters at once, else through L2; but the
    largest count that merges in a cluster where the L2 one cuts fewer than
    L2_MERGE_TILES[dtype] tiles off the longest split.  `_splits` (and
    `_cluster`: the splits, or 1) override them, for the card tests and
    the split benchmark, and raise above 8, where the card holds no
    cluster of that size, or where the L2 merge's grid does not fit."""
    q_tiles = -(-hw // query_tile(dtype))
    cv_tiles = cv // value_tile(cv)
    tiles = q_tiles * cv_tiles * b
    wave = max_clusters.get(1, 0)
    if _splits is None:
        bank = -(-t * hw // tile_positions(dtype))
        fit = [s for s in range(2, min(_MAX_SPLITS, bank // MIN_TILES_PER_SPLIT) + 1)
               if tiles * s <= wave]
        _splits = max(fit, default=1)
        one = max((s for s in fit if tiles <= max_clusters.get(s, 0)), default=1)
        if -(-bank // one) - -(-bank // _splits) < L2_MERGE_TILES[dtype]:
            _splits = one
    if not 1 <= _splits <= _MAX_SPLITS:
        raise ValueError(f"splits {_splits}: the kernel takes 1 to {_MAX_SPLITS}")
    if _splits == 1 and _cluster in (None, 1):
        return q_tiles, cv_tiles, 1, 1
    if _cluster is None:
        _cluster = (_splits if tiles <= max_clusters.get(_splits, 0) or tiles * _splits > wave
                    else 1)
    if _cluster == 1 and tiles * _splits > wave:
        raise ValueError(f"splits {_splits}: the L2 merge needs the grid's {tiles * _splits} "
                         f"blocks on the card at once, and it holds {wave}")
    if _cluster not in (1, _splits) or (_cluster > 1 and max_clusters.get(_cluster, 0) < 1):
        raise ValueError(f"splits {_splits}: no cluster of {_cluster} blocks fits on the card "
                         "(a cluster is a tile's splits)")
    return q_tiles, cv_tiles, _splits, _cluster


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def memory_read_plain(q_k: torch.Tensor, m_k: torch.Tensor, m_v: torch.Tensor,
                      slot_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """memory_read_xla in PyTorch.  q_k [B, HW, Ck]; m_k [B, T, HW, Ck];
    m_v [B, T, HW, Cv]; slot_mask [B, T] bool (True = valid) -> [B, HW, Cv]
    in q_k's dtype.  Products accumulate in fp32; p is cast to the value
    dtype before the second product, as in the reference."""
    b, t, hw, ck = m_k.shape
    cv = m_v.shape[-1]
    k = m_k.reshape(b, t * hw, ck).float()
    v = m_v.reshape(b, t * hw, cv)
    scores = torch.einsum("bqc,bkc->bqk", q_k.float(), k) / math.sqrt(ck)
    if slot_mask is not None:
        mask = slot_mask.bool().repeat_interleave(hw, dim=-1)       # [B, T*HW]
        scores = scores.masked_fill(~mask[:, None, :], _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bqk,bkv->bqv", p.to(v.dtype).float(), v.float())
    return out.to(q_k.dtype)


def memory_read_vjp_plain(q_k: torch.Tensor, m_k: torch.Tensor, m_v: torch.Tensor,
                          slot_mask: Optional[torch.Tensor], g: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The read's VJP, line for line otvm_tpu/kernels/memory_attn.py::
    _flash_bwd: S recomputed in fp32, the masked softmax, then dv, dp, ds,
    dq and dk in fp32, each cast back to its input's dtype.  g [B, HW, Cv]
    is the output's gradient -> (dq_k, dm_k, dm_v); the mask has none."""
    b, t, hw, ck = m_k.shape
    cv = m_v.shape[-1]
    k = m_k.reshape(b, t * hw, ck).float()
    v = m_v.reshape(b, t * hw, cv).float()
    q = q_k.float()
    scale = 1.0 / math.sqrt(ck)
    s = torch.einsum("bqc,bkc->bqk", q, k) * scale
    if slot_mask is not None:
        mask = slot_mask.bool().repeat_interleave(hw, dim=-1)       # [B, T*HW]
        s = s.masked_fill(~mask[:, None, :], _NEG_INF)
    p = torch.softmax(s, dim=-1)
    g32 = g.float()
    dv = torch.einsum("bqk,bqv->bkv", p, g32)
    dp = torch.einsum("bqv,bkv->bqk", g32, v)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.einsum("bqk,bkc->bqc", ds, k) * scale
    dk = torch.einsum("bqk,bqc->bkc", ds, q) * scale
    return (dq.to(q_k.dtype), dk.reshape(m_k.shape).to(m_k.dtype),
            dv.reshape(m_v.shape).to(m_v.dtype))


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 mantissa bits) toward zero: the 13 low
    bits of the fp32 pattern dropped, as wgmma reads an fp32 operand."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def memory_read_tf32_plain(q_k: torch.Tensor, m_k: torch.Tensor, m_v: torch.Tensor,
                           slot_mask: Optional[torch.Tensor] = None,
                           passes: int = 3) -> torch.Tensor:
    """memory_read_plain in fp32 with both products done as the fp32
    kernel's tensor cores do them: each operand x split into hi =
    tf32_round(x) (x as it stands, read by wgmma) and lo = tf32_round(x -
    hi) (x - hi is exact in fp32, and read the same way), a b summed in
    fp32 as a_hi b_lo + a_lo b_hi + a_hi b_hi (passes=3, 3xTF32), or as a_hi
    b_hi alone (passes=1, plain TF32).  A product of two TF32 values is
    exact in fp32, so fp32 matmuls of the halves emulate the tensor cores."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, not {passes}")

    def product(eq, a, b):
        a_hi, b_hi = tf32_round(a), tf32_round(b)
        out = torch.einsum(eq, a_hi, b_hi)
        if passes == 3:
            small = (torch.einsum(eq, a_hi, tf32_round(b - b_hi))
                     + torch.einsum(eq, tf32_round(a - a_hi), b_hi))
            out = small + out
        return out

    b, t, hw, ck = m_k.shape
    cv = m_v.shape[-1]
    scores = product("bqc,bkc->bqk", q_k.float(), m_k.reshape(b, t * hw, ck).float())
    scores = scores / math.sqrt(ck)
    if slot_mask is not None:
        mask = slot_mask.bool().repeat_interleave(hw, dim=-1)
        scores = scores.masked_fill(~mask[:, None, :], _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return product("bqk,bkv->bqv", p, m_v.reshape(b, t * hw, cv).float())


def memory_read_partials_plain(q_k: torch.Tensor, m_k: torch.Tensor, m_v: torch.Tensor,
                               slot_mask: Optional[torch.Tensor],
                               splits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial results of a read split over the memory positions, in the
    split kernel's form.  Split s takes the s-th of `splits` contiguous
    chunks of the T*HW positions and reads its live ones: the valid slots'
    positions, or every position when no slot is valid.  Per split, m = max
    score in log2 units (scores times log2(e) / sqrt(Ck), masked slots
    -1e30), l = sum of p = 2^(score - m), acc = p (rounded to the value
    dtype) times V.  -> acc [S, B, HW, Cv] fp32, ml [S, B, HW, 2] fp32; a
    split with no live position has m = -inf, l = acc = 0.  Merging the
    splits is exact for any partition, so the kernel's own (by K/V tiles)
    need not be this one."""
    b, t, hw, ck = m_k.shape
    cv = m_v.shape[-1]
    kv_len = t * hw
    v = m_v.reshape(b, kv_len, cv).float()
    x = torch.einsum("bqc,bkc->bqk", q_k.float(), m_k.reshape(b, kv_len, ck).float())
    x = x * (_LOG2E / math.sqrt(ck))
    mask = (torch.ones((b, t), dtype=torch.bool, device=q_k.device) if slot_mask is None
            else slot_mask.bool()).repeat_interleave(hw, dim=-1)           # [B, T*HW]
    x = x.masked_fill(~mask[:, None, :], _NEG_INF)
    live = mask | ~mask.any(dim=-1, keepdim=True)
    acc, ml = [], []
    for s in range(splits):
        lo, hi = s * kv_len // splits, (s + 1) * kv_len // splits
        xs = x[:, :, lo:hi].masked_fill(~live[:, None, lo:hi], -math.inf)
        m = xs.amax(dim=-1) if hi > lo else xs.new_full(xs.shape[:2], -math.inf)
        p = torch.exp2(xs - torch.where(torch.isinf(m), 0.0, m)[..., None])
        acc.append(p.to(m_v.dtype).float() @ v[:, lo:hi])
        ml.append(torch.stack([m, p.sum(dim=-1)], dim=-1))
    return torch.stack(acc), torch.stack(ml)


def combine_plain(acc: torch.Tensor, ml: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Merges split partials: acc [S, ..., Cv], ml [S, ..., 2] -> [..., Cv]
    in `dtype`: sum_s 2^(m_s - M) acc_s / sum_s 2^(m_s - M) l_s.  The plain
    version of the kernels' merge (merge_splits, csrc/memory_attn.cu), in
    a cluster or through L2."""
    m, l = ml[..., 0], ml[..., 1]
    w = torch.exp2(m - m.max(dim=0).values)
    return ((w[..., None] * acc).sum(dim=0) / (w * l).sum(dim=0)[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _not_capturing(what: str) -> None:
    """Raises inside a CUDA-graph capture: `what` is set-up that an eager
    read on the capture stream makes before the capture."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} inside a CUDA-graph capture: run the read once eagerly on "
                           "the capture stream before capturing it")


_tables: Dict[Tuple[int, torch.dtype, int, int], Dict[int, int]] = {}


def _cluster_table(device_index: int, dtype: torch.dtype, ck: int, cvt: int) -> Dict[int, int]:
    key = (device_index, dtype, ck, cvt)
    if key in _tables:
        return _tables[key]
    _not_capturing("the cluster occupancy query")
    lib = build()
    table = {}
    with torch.cuda.device(device_index):
        for blocks in range(1, _MAX_SPLITS + 1):
            count = ctypes.c_int(0)
            _check(lib.otvm_memory_read_max_clusters(int(dtype == torch.float32), ck, cvt,
                                                     blocks, ctypes.byref(count)),
                   "the cluster occupancy query")
            table[blocks] = count.value
    _tables[key] = table
    return table


def max_active_clusters(dtype: torch.dtype, ck: int, cv: int) -> Dict[int, int]:
    """{n: how many clusters of n blocks (2..8) of the read kernel for
    (dtype, Ck, Cv's value tile) the current card holds at once; 1: how
    many blocks}, from cudaOccupancyMaxActiveClusters and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor; queried once per card
    and kernel."""
    return dict(_cluster_table(torch.cuda.current_device(), dtype, ck, value_tile(cv)))


_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
# Workspaces outgrown on their stream.  A CUDA graph holds the addresses of
# the workspace its reads were captured with, so none is ever freed.
_outgrown: List[torch.Tensor] = []


def _workspace(device: torch.device, floats: int, counters: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The workspace of the L2 merge, for `device` and its current stream
    (launches on one stream run in turn): fp32 partials and the tiles'
    barrier counters, zeroed once (each launch leaves them fit for the
    next).  Made on first use and grown, never per call, and never inside
    a CUDA-graph capture.  A graph's replays use the workspace of the
    stream it was captured on, wherever they run: an eager read on that
    stream must not overlap a replay (models/graphs.py orders them)."""
    key = (device.index, torch.cuda.current_stream().cuda_stream)
    part, bars = _workspaces.get(key, (None, None))
    grow_part = part is None or part.numel() < floats
    grow_bars = bars is None or bars.numel() < counters
    if grow_part or grow_bars:
        _not_capturing("making the L2 merge's workspace")
        _outgrown.extend(x for x in (part, bars) if x is not None)
    if grow_part:
        part = torch.empty(floats, dtype=torch.float32, device=device)
    if grow_bars:
        bars = torch.zeros(counters, dtype=torch.int32, device=device)
    _workspaces[key] = (part, bars)
    return part, bars


@contextlib.contextmanager
def record_launches():
    """Around a CUDA-graph capture: the reads captured inside launch
    nothing now, so they are not counted but recorded, in the list this
    yields ((cluster merge, L2 merge) per read, as 0 or 1); each replay of
    the graph passes that list to `count_launches`.  A read captured
    outside this context raises, as its replays would go uncounted."""
    global _recorded
    if _recorded is not None:
        raise RuntimeError("record_launches does not nest")
    _recorded = reads = []
    try:
        yield reads
    finally:
        _recorded = None


def count_launches(reads: Iterable[Tuple[int, int]]) -> None:
    """Counts reads launched on the card: one by the wrapper's eager
    launch, or those a graph's capture recorded, at each replay."""
    global launches, cluster_launches, l2_merge_launches
    for cluster, l2 in reads:
        launches += 1
        cluster_launches += cluster
        l2_merge_launches += l2


def _on_own_card(fn):
    """Runs a wrapper with its first tensor's card as the current one: the
    kernels launch on the current card's current stream.  The switch costs
    host time, so it is made only where the card is not current already."""
    @functools.wraps(fn)
    def wrapper(x, *args, **kwargs):
        if x.is_cuda and x.device.index != torch.cuda.current_device():
            with torch.cuda.device(x.device):
                return fn(x, *args, **kwargs)
        return fn(x, *args, **kwargs)
    return wrapper


def _stream(x: torch.Tensor) -> int:
    """The current stream of x's card (the current card, by `_on_own_card`)."""
    return torch.cuda.current_stream().cuda_stream


@_on_own_card
def memory_read_cuda(q_k: torch.Tensor, m_k: torch.Tensor, m_v: torch.Tensor,
                     slot_mask: Optional[torch.Tensor] = None,
                     _splits: Optional[int] = None,
                     _cluster: Optional[int] = None) -> torch.Tensor:
    """The kernel (bf16: wgmma, fp32: 3xTF32 on wgmma), on the inputs'
    card: one launch, split and merged in a cluster or through L2 where
    `launch_geometry` says so; `_splits` and `_cluster` override its split
    count and cluster size, for the card tests and the split benchmark.
    Its output has no gradient: with grad enabled, inputs that require grad
    raise (`memory_read` takes them through `MemoryRead`).  Inside a CUDA-
    graph capture the launch is recorded (`record_launches`), not counted.
    Raises on what it does not take; never falls back."""
    if not (q_k.is_cuda and m_k.is_cuda and m_v.is_cuda):
        raise ValueError("memory_read_cuda needs CUDA tensors")
    if torch.is_grad_enabled() and (q_k.requires_grad or m_k.requires_grad
                                    or m_v.requires_grad):
        raise RuntimeError("memory_read_cuda gives no gradient: call memory_read, whose "
                           "autograd Function carries it, on inputs that require grad")
    if q_k.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"memory_read_cuda: dtype {q_k.dtype} not supported")
    if not (m_k.dtype == m_v.dtype == q_k.dtype):
        raise TypeError("memory_read_cuda: q, keys and values must share a dtype")
    if q_k.dim() != 3 or m_k.dim() != 4 or m_v.dim() != 4:
        raise ValueError("memory_read_cuda: want q [B,HW,Ck], bank [B,T,HW,C]")
    b, hw, ck = q_k.shape
    t = m_k.shape[1]
    cv = m_v.shape[-1]
    if tuple(m_k.shape) != (b, t, hw, ck) or tuple(m_v.shape[:3]) != (b, t, hw):
        raise ValueError(f"memory_read_cuda: shapes q {tuple(q_k.shape)}, keys "
                         f"{tuple(m_k.shape)}, values {tuple(m_v.shape)} disagree")
    if ck not in _KEY_DIMS or cv % _CV_SLICE or t > _MAX_SLOTS:
        raise ValueError(f"memory_read_cuda: Ck={ck} (want {_KEY_DIMS}), Cv={cv} "
                         f"(want a multiple of {_CV_SLICE}), T={t} (max {_MAX_SLOTS})")
    if not (q_k.is_contiguous() and m_k.is_contiguous() and m_v.is_contiguous()):
        raise ValueError("memory_read_cuda: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in (q_k, m_k, m_v)):
        raise ValueError("memory_read_cuda: inputs must be 16-byte aligned (TMA)")
    if slot_mask is None:
        mask = torch.ones((b, t), dtype=torch.uint8, device=q_k.device)
    elif tuple(slot_mask.shape) != (b, t):
        raise ValueError(f"memory_read_cuda: slot_mask {tuple(slot_mask.shape)} != {(b, t)}")
    elif (slot_mask.dtype in (torch.bool, torch.uint8) and slot_mask.device == q_k.device
          and slot_mask.is_contiguous()):
        mask = slot_mask    # one byte a slot, 0 or 1, as the kernel reads it
    else:
        mask = slot_mask.to(device=q_k.device, dtype=torch.uint8).contiguous()
    capturing = torch.cuda.is_current_stream_capturing()
    if capturing and _recorded is None:
        raise RuntimeError("memory_read_cuda captured in a CUDA graph outside record_launches(): "
                           "its replays would launch reads that no count sees")
    lib = build()
    read = lib.otvm_memory_read_bf16 if q_k.dtype == torch.bfloat16 else lib.otvm_memory_read_f32
    table = _cluster_table(q_k.device.index, q_k.dtype, ck, value_tile(cv))
    q_tiles, cv_tiles, n_split, blocks = launch_geometry(b, hw, t, cv, q_k.dtype, table,
                                                         _splits, _cluster)
    part = bars = None
    if n_split > blocks:
        part, bars = (x.data_ptr() for x in _workspace(
            q_k.device, n_split * b * hw * (cv + 2), 2 * b * q_tiles * cv_tiles))
    out = torch.empty((b, hw, cv), dtype=q_k.dtype, device=q_k.device)
    _check(read(q_k.data_ptr(), m_k.data_ptr(), m_v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                b, hw, t, ck, cv, n_split, blocks, part, bars, _stream(q_k)),
           "memory_read kernel launch")
    kind = (int(blocks > 1), int(blocks == 1 < n_split))
    if capturing:
        _recorded.append(kind)
    else:
        count_launches([kind])
    return out


class MemoryRead(torch.autograd.Function):
    """The read with a gradient (otvm_tpu's `_memory_read_flash` custom
    VJP): forward the kernel for CUDA tensors and the plain version on the
    CPU, backward `memory_read_vjp_plain`.  The backward recomputes S from
    the saved inputs, as `_flash_bwd` does, and launches no kernel."""

    @staticmethod
    def forward(ctx, q_k, m_k, m_v, slot_mask):
        ctx.save_for_backward(q_k, m_k, m_v, slot_mask)
        if q_k.is_cuda:
            return memory_read_cuda(q_k, m_k, m_v, slot_mask)
        return memory_read_plain(q_k, m_k, m_v, slot_mask)

    @staticmethod
    def backward(ctx, g):
        q_k, m_k, m_v, slot_mask = ctx.saved_tensors
        grads = memory_read_vjp_plain(q_k, m_k, m_v, slot_mask, g)
        return (*(d if need else None for d, need in zip(grads, ctx.needs_input_grad)), None)


def memory_read(q_k: torch.Tensor, m_k: torch.Tensor, m_v: torch.Tensor,
                slot_mask: Optional[torch.Tensor] = None,
                impl: Optional[str] = None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors.
    Inputs that require grad (grad enabled) go through `MemoryRead`; all
    others take the direct call, which costs the host less per frame.
    impl='plain' asks for the plain version on any device (for comparisons
    with the kernel; autograd differentiates it); it is never the default
    on CUDA."""
    if impl not in (None, "plain"):
        raise ValueError(f"unknown memory_read impl {impl!r}")
    if impl == "plain":
        return memory_read_plain(q_k, m_k, m_v, slot_mask)
    if torch.is_grad_enabled() and (q_k.requires_grad or m_k.requires_grad
                                    or m_v.requires_grad):
        return MemoryRead.apply(q_k, m_k, m_v, slot_mask)
    if not q_k.is_cuda:
        return memory_read_plain(q_k, m_k, m_v, slot_mask)
    return memory_read_cuda(q_k, m_k, m_v, slot_mask)
