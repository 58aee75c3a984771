"""Data-parallel training on N ranks, held to one process on the global batch.

    python -m otvm_tpu_torch.tools.ddp_check [--ranks 2] [--backend nccl|gloo]
        [--device cuda|cpu] [--scale 1] [--graphed] [--out FILE]

N ranks (parallel/dist.py spawn: one card a rank over NCCL; over gloo,
asked for by name, ranks may share a card) each take their rows of seeded
global batches (tools/profile_train.py seeded_batches at config.py's crop,
batch and clip length; row r's fg and bg pulled toward grey by (r+1)/B, so
that the ranks' rows differ in contrast and a rank's own exclusion-loss
ratio would differ from the global one) through the trainer's steps, the
gradients averaged over the ranks.  Then rank 0 takes the same steps alone
on the whole batches from the same init, and `verify` holds the runs
together:

  * after every step, every rank's parameters and RAdam moments bit-equal
    (checksums gathered);
  * the loss of each step through `state_at`, averaged over the ranks,
    within LOSS_RTOL of the 1-process loss;
  * RAdam's first moment after step `moments_at` (the mean gradient of
    those steps: RAdam moves no parameter before step 6), both moments
    after step `state_at`, norm-relative per network within STATE_TOL, and
    the parameters' change by then within PARAM_TOL.
On CUDA rank 0 also takes the held steps alone twice more, each as valid
a computation in other summation orders: every read unsplit (`_splits=1`),
and every read unsplit with cuDNN off (PyTorch's own convolutions).  At
full width with random weights stage-4 training amplifies rounding
(near-tied trimap argmaxes, fba_fusion's division): on an H100 the
unsplit reads alone move the 1-process gradient by 3-5% and cuDNN off by
12-23%, its step-1 loss by 4e-5 (PERF.md).  The ranks' rows run at
other shapes, so other split counts and cuDNN algorithms, and part from
the 1-process run alike.  So on CUDA a bound is the larger of the
tolerance and SPREAD_FACTOR times the variants' largest distance from the
1-process run (for the losses, over all held steps: a near-tie flips at
whichever step a perturbation meets it).  On the CPU the read has no split
and the bounds are the tolerances.
Later steps are printed beside the 1-process ones, not held: once the
parameters move, RAdam's m / sqrt(v) turns the runs' fp32 rounding
differences in near-zero gradients into whole steps of the learning rate,
and the runs part a little more each step (at model scale 4 on the CPU,
parameter changes 5e-3 apart after 5 updates).

On CUDA every read of a checked step (forward, the remat re-run, and the
backward) is held in lockstep to the plain read (tools/kernel_check.py) in
every rank, and each rank counts its read launches.  Timed steps run
unchecked: CUDA-event ms a step in both runs, the gradient all-reduce's ms
(host clock around it, the card synchronized before and after), and in one
profiled step on rank 0 the device time of NCCL's kernels and of copies.

`--graphed` (`run_graphed`, NCCL): the step each rank replays from a CUDA
graph with its collectives captured (train/graphs.py) against the eager
step, not against 1 process.  Each rank takes GRAPHED_CASES on its rows
(fp32 stage 4 over 8 steps, then remat, bf16 and trimap-s1), each graphed
step in lockstep with the eager step from the same state under torch's
deterministic algorithms (tools/train_graphs_check.py lockstep: loss,
gradients, update and moments bit for bit, the ranks bit-equal after every
step, the reads counted at every replay).  With 2 ranks any order of a sum
of two rounds alike; with more, NCCL may sum in another order inside a
graph than eagerly, so the bit-for-bit run pins NCCL's algorithm and
protocol (PINNED) for both, and an unpinned run is held within the
tolerances of `bounds` (GRAPHED_TOL) and timed.  At 1 rank it runs in a
one-rank NCCL group.  Timed on rank 0: ms a step graphed and eager (CUDA
events), host ms in the step call, and one profiled step of each (NCCL's
kernels by name; the eager all-reduce's host ms).
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import get_cfg_defaults
from ..kernels import memory_attn as ma
from ..parallel import dist as D
from ..train import trainer as T
from . import train_graphs_check as G
from .kernel_check import lockstep_check, lockstep_grad_check
from .profile_train import seeded_batches

LOSS_RTOL = 1e-5
# The moments, linear in the gradients: fp32 summation order, B rows summed
# in one process, B/N per rank and then over the ranks (measured <= 9e-6 at
# model scale 4 on the CPU; PERF.md).
STATE_TOL = 1e-4
# RAdam's update is m / (sqrt(v) + eps) elementwise: where a gradient
# element sits at the fp32 rounding floor its sign is noise and its update
# a whole step of the learning rate either way (measured 4.5e-4 after the
# first update, step 6, at model scale 4 on the CPU).  A gradient summed
# wrongly moves it by ~1.
PARAM_TOL = 1e-2
SPREAD_FACTOR = 2.0


@dataclasses.dataclass
class Line:
    """One run of steps from a fresh seeded init.  steps: each one of
    "checked" (fp32, reads in lockstep), "remat" (fp32 with remat,
    checked), "timed" (fp32, unchecked, timed), "bf16" (checked)."""
    name: str
    stage: int
    steps: Sequence[str]
    state_at: int
    trimap: bool = False
    moments_at: Optional[int] = None


# chip_smoke.py phase 9 and tests/test_torch_ddp_cuda.py: stage 4 with a remat
# step among the first 6 (the parameters move at step 6), 3 timed steps and
# a bf16 step after; a stage-1 step (the exclusion loss without the
# propagated trimaps) and a trimap-s1 step
CARD_LINES = (Line("stage4", 4, ("checked",) * 3 + ("remat", "checked", "checked")
                   + ("timed",) * 3 + ("bf16",), state_at=6, moments_at=3),
              Line("stage1", 1, ("checked",), state_at=1, moments_at=1),
              Line("trimap_s1", 1, ("checked",), state_at=1, trimap=True, moments_at=1))


def global_batches(cfg, n: int, seed: int) -> List[Dict[str, np.ndarray]]:
    """n of seeded_batches' global batches, row r's fg and bg pulled
    toward grey (127.5) by the factor (r+1)/B."""
    out = []
    for batch in seeded_batches(cfg, n, seed):
        b = batch["fg"].shape[0]
        c = ((np.arange(b) + 1.0) / b).reshape(b, 1, 1, 1, 1)
        for k in ("fg", "bg"):
            batch[k] = np.round(127.5 + (batch[k].astype(np.float32) - 127.5) * c).astype(np.uint8)
        out.append(batch)
    return out


def _line_cfg(line: Line, scale: int, size: Optional[int], frames: Optional[int]):
    cfg = get_cfg_defaults()
    cfg.train.stage, cfg.model_scale = line.stage, scale
    if size:
        cfg.train.train_input_size = (size, size)
    if frames:
        cfg.train.frame_num = frames
    return cfg


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _params(state):
    return state.optimizer.param_groups[0]["params"]


def _moments(state, key):
    return [state.optimizer.state[p][key] for p in _params(state)]


def _snapshot(state) -> Dict[str, List[torch.Tensor]]:
    return {"params": [p.detach().clone() for p in _params(state)],
            "exp_avg": [m.clone() for m in _moments(state, "exp_avg")],
            "exp_avg_sq": [v.clone() for v in _moments(state, "exp_avg_sq")]}


def _fresh_copy(cfg, state):
    """A TrainState with copies of a fresh state's networks (its random
    init, without drawing it again) and a fresh optimizer."""
    stm, fba = copy.deepcopy(state.stm), copy.deepcopy(state.fba)
    return T.TrainState(stm, fba, T.make_optimizer(cfg, stm, fba, iters_per_epoch=1))


def _net_of(state) -> List[str]:
    stm = {id(p) for p in state.stm.parameters()}
    return ["stm" if id(p) in stm else "fba" for p in _params(state)]


def _norm_rel(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor], nets) -> Dict[str, float]:
    """{network: ||got - want|| / ||want||} over its tensors (0 where both
    are 0, inf where only `got` is not)."""
    errs = {}
    for net in sorted(set(nets)):
        d2 = sum(float(((g.double() - w.double()) ** 2).sum())
                 for g, w, n in zip(got, want, nets) if n == net)
        w2 = sum(float((w.double() ** 2).sum()) for w, n in zip(want, nets) if n == net)
        errs[net] = (d2 / w2) ** 0.5 if w2 else (float("inf") if d2 else 0.0)
    return errs


class _Steps:
    """The line's steps, made once a kind."""

    def __init__(self, cfg, trimap: bool):
        self.cfg, self.trimap, self.made = cfg, trimap, {}

    def __call__(self, kind: str):
        if kind not in self.made:
            cfg = dataclasses.replace(self.cfg, train=dataclasses.replace(
                self.cfg.train, bf16=kind == "bf16"))
            # eager: the lockstep checks and the gradient all-reduce read the host
            self.made[kind] = (T.make_trimap_s1_train_step(cfg, graphs=False) if self.trimap
                               else T.make_train_step(cfg, remat=kind == "remat", graphs=False))
        return self.made[kind]


def expected_reads(line: Line, kind: str, frames: int, device) -> Tuple[int, Tuple[int, int]]:
    """(read kernel launches, lockstep checks (forward, backward)) of one
    step on `device`: a read for each propagated frame (frames - 1) where
    the trimap net runs (stage > 1, trimap-s1), again in the backward
    under remat; checks on CUDA in every step but the timed ones."""
    if device.type != "cuda" or not (line.trimap or line.stage > 1):
        return 0, (0, 0)
    reads = (frames - 1) * (2 if kind == "remat" else 1)
    return reads, ((0, 0) if kind == "timed" else (reads, frames - 1))


@contextlib.contextmanager
def _timed_all_reduce(device, ms: List[float]):
    """D.all_reduce_gradients timed on the host clock (the card
    synchronized before and after) while active: ms appended."""
    run = D.all_reduce_gradients

    def timed(*args, **kwargs):
        _sync(device)
        t0 = time.perf_counter()
        run(*args, **kwargs)
        _sync(device)
        ms.append(1e3 * (time.perf_counter() - t0))

    D.all_reduce_gradients = timed
    try:
        yield
    finally:
        D.all_reduce_gradients = run


def _run_line(line: Line, cfg, state, batches, rows, device, log: Dict):
    """The line's steps on `state` (rows `rows` of each batch), recording
    in log[line.name] per step: this rank's loss, the ranks' mean loss,
    reads, the lockstep errors, whether the ranks are bit-equal, ms; and
    snapshots.  Returns the state."""
    steps, group = _Steps(cfg, line.trimap), state.group
    ar_ms = []
    out = dict(step=[], snap={})
    for i, kind in enumerate(line.steps):
        batch = {k: v[rows] for k, v in batches[i].items()}
        checked = device.type == "cuda" and kind != "timed"
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        ma_before = ma.launches
        with (_timed_all_reduce(device, ar_ms) if kind == "timed" else contextlib.nullcontext()), \
                (lockstep_check(dt) if checked else contextlib.nullcontext([])) as fwd, \
                (lockstep_grad_check(dt) if checked else contextlib.nullcontext([])) as bwd:
            _sync(device)
            t0 = time.perf_counter()
            start, end = _events(device)
            state, metrics = steps(kind)(state, batch)
            ms = _elapsed(start, end, t0, device)
        loss = metrics["loss"].item()
        mean = D.all_reduce_mean([metrics["loss"]], group)[0].item() if group else loss
        equal = D.ranks_equal([*_params(state), *_moments(state, "exp_avg"),
                               *_moments(state, "exp_avg_sq")], group) if group else True
        out["step"].append(dict(kind=kind, rank_loss=loss, loss=mean, ranks_equal=equal, ms=ms,
                                reads=ma.launches - ma_before,
                                want=expected_reads(line, kind, cfg.train.frame_num, device),
                                fwd_err=max(fwd, default=None),
                                bwd_err=max(bwd, default=None), checks=(len(fwd), len(bwd))))
        if not (np.isfinite(loss) and equal):
            raise AssertionError(f"{line.name} step {i + 1} ({kind}): rank {D.process_index()} "
                                 f"loss {loss}, ranks bit-equal {equal}")
        if line.moments_at == i + 1:
            out["snap"]["moments_at"] = [m.clone() for m in _moments(state, "exp_avg")]
        if line.state_at == i + 1:
            out["snap"]["state_at"] = _snapshot(state)
    out["all_reduce_ms"] = ar_ms
    log[line.name] = out
    return state


def _events(device):
    if device.type != "cuda":
        return None, None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    return start, end


def _elapsed(start, end, t0, device) -> float:
    if start is None:
        return 1e3 * (time.perf_counter() - t0)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _profile_step(state, step, batch, device) -> Dict:
    """One step under torch.profiler on this rank: its CUDA-event ms, the
    device ms of its kernels, of NCCL's (in all and by name) and of memory
    copies (gloo's path through the host, a one-rank NCCL group's
    all-reduce), and the eager all-reduce's host ms (synchronized)."""
    from torch.profiler import ProfilerActivity, profile

    ar_ms = []
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            _timed_all_reduce(device, ar_ms):
        start, end = _events(device)
        step(state, batch)
        ms = _elapsed(start, end, 0.0, device)
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    kernels = [e for e in prof.key_averages() if dev(e) > 0]
    nccl = {e.key: dev(e) / 1e3 for e in kernels if "nccl" in e.key.lower()}
    return dict(ms=ms, device_ms=sum(dev(e) for e in kernels) / 1e3,
                nccl_ms=sum(nccl.values()), nccl=nccl, all_reduce_host_ms=ar_ms,
                memcpy_ms=sum(dev(e) for e in kernels if "memcpy" in e.key.lower()) / 1e3)


def _rank_main(device, backend, lines, scale, size, frames, seed):
    device = D.init_distributed(device, backend)
    group, rank, world = D.data_group(), D.process_index(), D.process_count()
    log, ref = {}, {}
    variants = {v: {} for v in _VARIANTS} if device.type == "cuda" else {}
    for line in lines:
        cfg = _line_cfg(line, scale, size, frames)
        b = cfg.train.batch_size
        if b % world:
            raise ValueError(f"global batch {b} over {world} ranks")
        rows = slice(rank * b // world, (rank + 1) * b // world)
        batches = global_batches(cfg, len(line.steps) + 1, seed)
        state = T.init_train_state(cfg, seed, device=device, group=group)
        state = _run_line(line, cfg, state, batches, rows, device, log)
        if "timed" in line.steps and device.type == "cuda":
            step = _Steps(cfg, line.trimap)("timed")
            prof = _profile_step(state, step, {k: v[rows] for k, v in batches[-1].items()},
                                        device)
            log[line.name]["profiled"] = prof
        del state
        if rank == 0:       # the same steps alone on the whole batches, from the same init
            alone = T.init_train_state(cfg, seed, device=device)
            fresh = [_fresh_copy(cfg, alone) for _ in variants]
            init = [p.detach().clone() for p in _params(alone)]
            _run_line(line, cfg, alone, batches, slice(None), device, ref)
            ref[line.name]["init"], ref[line.name]["nets"] = init, _net_of(alone)
            del alone
            held = dataclasses.replace(line, steps=line.steps[:line.state_at])
            for (variant, log_v), alone in zip(variants.items(), fresh):
                with _VARIANTS[variant]():      # and its held steps in other orders
                    _run_line(held, cfg, alone, batches, slice(None), device, log_v)
            del fresh
        if device.type == "cuda":
            torch.cuda.empty_cache()
        if group is not None:
            torch.distributed.barrier()
    result = dict(rank=rank, device=str(device), backend=D.backend(),
                  card=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                  lines={name: dict(step=out["step"], all_reduce_ms=out["all_reduce_ms"],
                                    profiled=out.get("profiled")) for name, out in log.items()})
    if rank == 0:
        result["compare"] = {line.name: _compare(line, log[line.name], ref[line.name])
                             for line in lines}
        result["spread"] = {line.name: {v: _compare(line, log_v[line.name], ref[line.name])
                                        for v, log_v in variants.items()} for line in lines}
        result["alone"] = {name: dict(step=out["step"]) for name, out in ref.items()}
    return result


@contextlib.contextmanager
def _unsplit_reads():
    """Every read kernel launched unsplit while active."""
    launch = ma.memory_read_cuda
    ma.memory_read_cuda = lambda q, k, v, mask=None: launch(q, k, v, mask, _splits=1)
    try:
        yield
    finally:
        ma.memory_read_cuda = launch


@contextlib.contextmanager
def _unsplit_reads_without_cudnn():
    with torch.backends.cudnn.flags(enabled=False), _unsplit_reads():
        yield


_VARIANTS = {"reads unsplit": _unsplit_reads, "reads unsplit, cuDNN off": _unsplit_reads_without_cudnn}


def _compare(line: Line, ranks: Dict, alone: Dict) -> Dict:
    """Another run of one line (the ranks', or a variant of the 1-process
    run) against the 1-process run."""
    nets = alone["nets"]
    loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                for a, b in zip(ranks["step"], alone["step"])]
    out = dict(loss_rel=loss_rel, held=[i < line.state_at for i in range(len(loss_rel))])
    if "moments_at" in alone["snap"]:
        out["moments_at"] = _norm_rel(ranks["snap"]["moments_at"], alone["snap"]["moments_at"],
                                      nets)
    if "state_at" in alone["snap"]:
        got, want = ranks["snap"]["state_at"], alone["snap"]["state_at"]
        init = alone["init"]
        out["params_moved"] = any(not torch.equal(p, p0) for p, p0 in zip(want["params"], init))
        out["param_delta"] = _norm_rel([p - p0 for p, p0 in zip(got["params"], init)],
                                       [p - p0 for p, p0 in zip(want["params"], init)], nets)
        out["exp_avg"] = _norm_rel(got["exp_avg"], want["exp_avg"], nets)
        out["exp_avg_sq"] = _norm_rel(got["exp_avg_sq"], want["exp_avg_sq"], nets)
    return out


def run(world: int, device=None, backend: Optional[str] = None, lines=CARD_LINES,
        scale: int = 1, size: Optional[int] = None, frames: Optional[int] = None,
        seed: int = 0) -> List[Dict]:
    """`lines` on `world` ranks and, on rank 0, alone (and on CUDA its
    variants); each rank's result (rank 0's with 'compare', 'alone' and
    'spread').  size, frames: the crop and the clip length, where not
    config.py's."""
    resolve_device(device)
    return D.spawn(_rank_main, world, device, backend, tuple(lines), scale, size, frames, seed)


def bounds(results: List[Dict]) -> Dict:
    """{line: {quantity: bound}}: each tolerance, or on CUDA SPREAD_FACTOR
    times the variants' largest distance from the 1-process run where that
    is larger (per network; for the losses, the largest over the held
    steps)."""
    out = {}
    for name, cmp in results[0]["compare"].items():
        spread = list(results[0].get("spread", {}).get(name, {}).values())
        loss = max((x for sp in spread for x in sp["loss_rel"]), default=0.0)
        b = dict(loss_rel=[max(LOSS_RTOL, SPREAD_FACTOR * loss)] * len(cmp["loss_rel"]))
        for key, tol in (("moments_at", STATE_TOL), ("exp_avg", STATE_TOL),
                         ("exp_avg_sq", STATE_TOL), ("param_delta", PARAM_TOL)):
            if key in cmp:
                b[key] = {net: max(tol, SPREAD_FACTOR * max((sp[key][net] for sp in spread),
                                                             default=0.0)) for net in cmp[key]}
        out[name] = b
    return out


def verify(results: List[Dict]) -> None:
    """Raises AssertionError where a rank's step launched or checked
    another number of reads than expected_reads, or where the ranks' run
    and the 1-process run of a line part by more than `bounds`."""
    for r in results:
        for name, line in r["lines"].items():
            for i, s in enumerate(line["step"]):
                assert (s["reads"], tuple(s["checks"])) == (s["want"][0], tuple(s["want"][1])), \
                    f"rank {r['rank']} {name} step {i + 1} ({s['kind']}): reads {s['reads']}, " \
                    f"lockstep checks {s['checks']}, want {s['want']}"
    for name, b in bounds(results).items():
        cmp = results[0]["compare"][name]
        for i, (rel, held) in enumerate(zip(cmp["loss_rel"], cmp["held"])):
            assert not held or rel <= b["loss_rel"][i], f"{name} step {i + 1}: loss {rel:.3e} " \
                f"from the 1-process loss (bound {b['loss_rel'][i]:.3g})"
        for key in ("moments_at", "exp_avg", "exp_avg_sq", "param_delta"):
            for net, err in cmp.get(key, {}).items():
                assert err <= b[key][net], f"{name}: {key} of {net} {err:.3e} from the " \
                    f"1-process run (bound {b[key][net]:.3g})"


def summary(results: List[Dict]) -> str:
    """Printable lines: per line, each rank's reads a step, losses, and
    the comparison; the timed steps' ms beside the 1-process ones."""
    r0 = results[0]
    lines = [f"{len(results)} ranks over {r0['backend']} on {r0['card']} "
             f"({', '.join(r['device'] for r in results)})"]
    for name, cmp in r0["compare"].items():
        alone = r0["alone"][name]["step"]
        for r in results:
            steps = r["lines"][name]["step"]
            lines.append(f"  {name} rank {r['rank']}: reads a step "
                         f"{[s['reads'] for s in steps]}, lockstep checks (fwd, bwd) "
                         f"{[s['checks'] for s in steps]}, max err fwd "
                         f"{max((s['fwd_err'] for s in steps if s['fwd_err'] is not None), default=None)}"
                         f" bwd {max((s['bwd_err'] for s in steps if s['bwd_err'] is not None), default=None)}")
        lines.append(f"  {name} losses, ranks' mean vs alone: " + ", ".join(
            f"{s['kind']} {s['loss']:.6f}/{a['loss']:.6f}" for s, a in
            zip(r0["lines"][name]["step"], alone)))
        lines.append(f"  {name} vs alone: loss rel {max(cmp['loss_rel']):.3e} (max), " + ", ".join(
            f"{k} {json.dumps(cmp[k])}" for k in ("moments_at", "param_delta", "exp_avg",
                                                  "exp_avg_sq") if k in cmp)
            + (f", parameters moved {cmp['params_moved']}" if "params_moved" in cmp else ""))
        for variant, spread in r0.get("spread", {}).get(name, {}).items():
            lines.append(f"  {name} alone, {variant}, vs alone: loss rel " + ", ".join(
                f"{x:.3e}" for x in spread["loss_rel"]) + "; " + ", ".join(
                f"{k} {json.dumps(spread[k])}" for k in ("moments_at", "param_delta", "exp_avg",
                                                         "exp_avg_sq") if k in spread))
        lines.append(f"  {name} bounds: {json.dumps(bounds(results)[name])}")
        timed = [i for i, s in enumerate(alone) if s["kind"] == "timed"]
        if timed:
            ms = np.median([r0["lines"][name]["step"][i]["ms"] for i in timed])
            ms1 = np.median([alone[i]["ms"] for i in timed])
            ar = np.median(r0["lines"][name]["all_reduce_ms"])
            lines.append(f"  {name} timed: {ms:.1f} ms a step on {len(results)} ranks, {ms1:.1f} "
                         f"ms alone ({ms / ms1:.2f}x); gradient all-reduce {ar:.1f} ms "
                         f"({ar / ms:.1%} of the step); profiled {r0['lines'][name]['profiled']}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the graphed data-parallel step against the eager one
# ---------------------------------------------------------------------------

# chip_smoke.py phase 12 and tests/test_torch_ddp_cuda.py: fp32 stage 4
# across RAdam's hold into its first updates (step 6), then remat, bf16 and
# trimap-s1 steps; a key's first step is eager, its second captured and
# replayed, so each short case replays from its second step on
GRAPHED_CASES = (G.Case("fp32 stage 4", 8), G.Case("fp32 stage 4, remat", 3, remat=True),
                 G.Case("bf16 stage 4", 3, bf16=True),
                 G.Case("trimap-s1", 3, stage=1, trimap=True))
# NCCL's algorithm and protocol pinned in the ranks' environment, for the
# graphed and the eager run alike: at more than 2 ranks another algorithm
# (a capture may get another than an eager call, or NVLS on an NVSwitch
# machine) sums the ranks in another order, another rounding
PINNED = {"NCCL_ALGO": "Ring", "NCCL_PROTO": "Simple"}
# a graphed step not bit-equal to the eager one (NCCL unpinned at more
# than 2 ranks) is held to the eager one within the tolerances of `bounds`
GRAPHED_TOL = {"loss": LOSS_RTOL, "grad": STATE_TOL, "exp_avg": STATE_TOL,
               "exp_avg_sq": STATE_TOL, "delta": PARAM_TOL}


def _join(device, backend, world: int):
    """(this rank's device, its group): init_distributed's, or at world 1
    over NCCL a one-rank group (init_distributed joins none there), whose
    collectives are still NCCL's, captured and replayed."""
    if world == 1 and backend == "nccl":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
        torch.distributed.init_process_group("nccl", init_method="env://", rank=0, world_size=1)
        return device, torch.distributed.group.WORLD
    device = D.init_distributed(device, backend)
    return device, D.data_group()


def _profiled(case, cfg, nets, batches, graphs: bool, device) -> Dict:
    """A graphed run's warm-up, capture and a replay (an eager run's first
    step), then one step profiled (`_profile_step`)."""
    state = nets.fresh(cfg, G.RAdam)
    step = case.make_step(cfg, graphs)
    warm = 3 if graphs else 1
    for batch in batches[:warm]:
        state, _ = step(state, batch)
    out = _profile_step(state, step, batches[warm], device)
    state.optimizer.zero_grad(set_to_none=True)
    del step, state
    _sync(device)
    torch.cuda.empty_cache()
    return out


def _graphed_main(device, backend, cases, scale, size, frames, seed, env, timing, eager_runs):
    # the lockstep's deterministic mode asks this of cuBLAS before its first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", G.CUBLAS_DETERMINISTIC)
    os.environ.update(env)
    world = int(os.environ["WORLD_SIZE"])
    device, group = _join(device, backend, world)
    rank = D.process_index()
    out = dict(rank=rank, device=str(device), backend=D.group_backend(group), env=env,
               card=torch.cuda.get_device_name(device), cases={})
    nets = {}
    with torch.cuda.device(device):
        for case in cases:
            cfg = _line_cfg(Line(case.name, case.stage, (), 0), scale, size, frames)
            b = cfg.train.batch_size
            if b % world:
                raise ValueError(f"global batch {b} over {world} ranks")
            rows = slice(rank * b // world, (rank + 1) * b // world)
            batches = [{k: v[rows] for k, v in batch.items()}
                       for batch in global_batches(cfg, max(case.steps, timing, 4), seed)]
            if case.stage not in nets:      # one stage's networks on the card at a time
                nets.clear()
                torch.cuda.empty_cache()
                nets[case.stage] = G.Nets(cfg, seed, device, group)
            res = dict(lockstep=G.lockstep(case, cfg, nets[case.stage], batches,
                                           eager_runs=eager_runs),
                       reads_per_step=case.reads_per_step(case.config(cfg)))
            if timing and case is cases[0]:
                alone = dataclasses.replace(case, steps=timing)
                res.update(graphed=G.timed(alone, cfg, nets[case.stage], batches, True),
                           eager=G.timed(alone, cfg, nets[case.stage], batches, False))
                res["profiled"] = {name: _profiled(case, cfg, nets[case.stage], batches, graphs,
                                                   device)
                                   for name, graphs in (("graphed", True), ("eager", False))}
            out["cases"][case.name] = res
            torch.distributed.barrier()
    nets.clear()
    return out


def run_graphed(world: int, device=None, backend: str = "nccl", cases=GRAPHED_CASES,
                scale: int = 1, size: Optional[int] = None, frames: Optional[int] = None,
                seed: int = 0, pinned: bool = False, timing: int = 8,
                eager_runs: int = G.EAGER_RUNS, timeout: Optional[float] = None) -> List[Dict]:
    """`cases` on `world` ranks (at world 1 over NCCL, a one-rank group),
    each graphed step in lockstep with `eager_runs` eager steps from the
    same state under torch's deterministic algorithms
    (train_graphs_check.lockstep, the ranks bit-equal after every step);
    then, where `timing` (a number of steps, at least 3), the first case
    graphed and eager alone over so many steps in the default mode (ms a
    step, host ms in the step call) and one profiled step of each (NCCL's
    kernels).  pinned: NCCL's algorithm and protocol pinned (PINNED) in
    every rank.  Each rank's result, by rank."""
    env = dict(PINNED) if pinned else {}
    return D.spawn(_graphed_main, world, device, backend, tuple(cases), scale, size, frames,
                   seed, env, timing, eager_runs, timeout=timeout)


def verify_graphed(results: List[Dict], exact: bool = True) -> None:
    """Raises AssertionError where a rank's graphed step parted from its
    eager step (bit for bit where `exact`, else within GRAPHED_TOL, the
    eager steps repeatable either way), where the ranks were not
    bit-equal after a step, where a run captured other than one graph, or
    launched other than its reads a step at every step and replay."""
    for r in results:
        for name, res in r["cases"].items():
            lock, reads = res["lockstep"], res["reads_per_step"]
            failures = G.verify(lock)
            if not exact:
                failures = [f for f in failures if "graphed differs" not in f]
                for i, s in enumerate(lock["steps"]):
                    failures += [f"{k} of step {i + 1}: {s['distance'][k]:.3e} from eager "
                                 f"(bound {tol:g})" for k, tol in GRAPHED_TOL.items()
                                 if not s["equal"][k] and not s["distance"][k] <= tol]
            where = f"rank {r['rank']} {name}"
            assert not failures, f"{where}: {failures}"
            assert all(s["ranks_equal"] for s in lock["steps"]), f"{where}: ranks differ"
            n = len(lock["steps"])
            assert lock["captures"] == 1, f"{where}: {lock['captures']} captures"
            assert lock["graphed_launches"] == reads * n and \
                lock["launches"] == reads * n * (lock["eager_runs"] + 1), \
                f"{where}: reads {lock['graphed_launches']} graphed, {lock['launches']} in all, " \
                f"want {reads} a step"
            for kind in ("graphed", "eager"):
                if kind in res:
                    assert res[kind]["launches"] == reads * len(res[kind]["ms"]), \
                        f"{where}: {kind} alone launched {res[kind]['launches']} reads"


def summary_graphed(results: List[Dict]) -> str:
    """Printable lines: per case, each rank's lockstep (steps bit-equal,
    ranks equal, reads), and the timed runs beside each other."""
    r0 = results[0]
    lines = [f"{len(results)} rank(s) over {r0['backend']} on {r0['card']} "
             f"({', '.join(r['device'] for r in results)}); NCCL environment {r0['env'] or 'unpinned'}"]
    for name, res in r0["cases"].items():
        for r in results:
            lock = r["cases"][name]["lockstep"]
            equal = ["yes" if all(s["equal"].values()) else "NO" for s in lock["steps"]]
            lines.append(f"  {name} rank {r['rank']}: graphed = eager bit for bit a step "
                         f"{equal}, ranks equal {[s['ranks_equal'] for s in lock['steps']]}, "
                         f"reads graphed {lock['graphed_launches']} merged "
                         f"{lock['graphed_merges']}, in all {lock['launches']}, captures "
                         f"{lock['captures']} ({lock['capture_s']:.2f} s)")
        if "graphed" in res:
            g, e = res["graphed"], res["eager"]
            pg, pe = res["profiled"]["graphed"], res["profiled"]["eager"]
            lines.append(
                f"  {name} timed on rank 0: graphed {g['step_ms']:.1f} ms a step (host "
                f"{g['host_step_ms']:.2f} ms in the step call), eager {e['step_ms']:.1f} ms "
                f"(host {e['host_step_ms']:.2f}), {e['step_ms'] / g['step_ms']:.2f}x; peak "
                f"{g['peak_gb']:.2f} / {e['peak_gb']:.2f} GB; profiled: graphed {pg['ms']:.1f} "
                f"ms, kernels {pg['device_ms']:.1f} ms, NCCL {pg['nccl_ms']:.2f} ms "
                f"({pg['nccl_ms'] / pg['ms']:.1%}), copies {pg['memcpy_ms']:.2f} ms; eager "
                f"{pe['ms']:.1f} ms, NCCL "
                f"{pe['nccl_ms']:.2f} ms, all-reduce host {pe['all_reduce_host_ms']} ms; NCCL "
                f"kernels {json.dumps(pg['nccl'])}")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--graphed", action="store_true",
                    help="the graphed step against the eager one (NCCL; pinned at more than 2 "
                         "ranks, then unpinned with its timing), not the ranks against 1 process")
    ap.add_argument("--out", default=None, help="the results as JSON")
    args = ap.parse_args()
    if args.graphed:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", G.CUBLAS_DETERMINISTIC)
        runs = {}
        if args.ranks > 2:
            runs["pinned"] = run_graphed(args.ranks, args.device, scale=args.scale, pinned=True)
        runs["unpinned"] = run_graphed(args.ranks, args.device, scale=args.scale,
                                       cases=GRAPHED_CASES[:1] if runs else GRAPHED_CASES)
        for name, results in runs.items():
            print(summary_graphed(results))
        results = runs
    else:
        results = run(args.ranks, args.device, args.backend, scale=args.scale)
        print(summary(results))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    if args.graphed:
        for name, res in results.items():
            verify_graphed(res, exact=name == "pinned" or args.ranks <= 2)
    else:
        verify(results)


if __name__ == "__main__":
    main()
