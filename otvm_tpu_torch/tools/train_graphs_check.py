"""The train step replayed from CUDA graphs (train/graphs.py) held to the
eager step bit for bit, on one CUDA card.

A case is one step kind (stage-4 joint in fp32 or bf16, remat, stages
1-3, trimap-s1) over `steps` steps from one seeded init
(`seeded_batches`).  `lockstep` drives the graphed step (the key's first
step eager, the second captured and replayed, the rest replays) and,
before each of its steps, takes the same step eagerly EAGER_RUNS times
from the same state, copying the state back in place after each (a graph
holds its addresses).

Under torch.use_deterministic_algorithms(True) (`deterministic`).  The
eager step is not repeatable otherwise: torch's CUDA backward of bilinear
interpolation, adaptive average pooling and reflect padding adds with
atomics in an order the blocks' timing sets, and at scale 4 two eager steps
from one state then part by a tail of distances that no bound from a few
runs holds (a bound of twice the spread of three runs rejected an eager
step).  In that mode torch refuses those ops and the port's (nn/ops.py)
take forms whose backward has no atomics, so two eager steps from one
state agree bit for bit (measured at every step: EAGER_RUNS of them), and
the graphed step, the same kernels on the same addresses, must equal them
bit for bit.  `verify` holds, at every step:
  * the eager steps repeatable: their loss, gradients, change to the
    parameters and RAdam's moments equal bit for bit;
  * the graphed step's equal to theirs bit for bit (gradients: the
    parameters' `.grad` after the step, which a replay binds to the pool's);
  * RAdam's hold: no parameter moves while its count is at most 5;
  * the metrics kept across steps are the steps' own (not the pool's);
  * with a process group (`Nets(group=...)`, tools/ddp_check.py), every
    rank's parameters and moments bit-equal after the graphed step.

Controls, which `verify` must reject: `FrozenScalarRAdam` computes a step's
scalars on the host, as the port's RAdam did before its count moved to
the device; eagerly it equals RAdam, captured it replays the capture
step's step size and decay at every step (captured at step 2, RAdam's
held zero for good; at step 9, the learning rate of before a stair drop at
step 10).  `FrozenDecayRAdam` freezes the decay alone, a small error: from
the drop on, each update is off by 0.9 * weight_decay * lr * p (its
distance is in `lockstep`'s result).

`timed` runs the graphed or the eager step alone from the init, in the
default (atomic) mode: ms a step (CUDA events, median over steps 3 on: the
replays), host ms in the step call, read launches and merges, captures
and their seconds, peak memory allocated and reserved, the losses (those
of steps 1-6 are the init's parameters' in both runs, so equal bit for
bit).  `chip_smoke.py` phase 11 runs the cases at full width,
tests/test_torch_train_graphs_cuda.py at scale 4 and full width on 64x64
crops.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..kernels import memory_attn as ma
from ..parallel import dist as D
from ..train import trainer as T
from ..train.optim import RAdam, _f32, rectified_scalars
from ..utils.checkpoint import restore_train_state

MOVED = 6               # RAdam's first update: its count reaches 6
EAGER_RUNS = 2          # eager steps from each state in lockstep
QUANTITIES = ("loss", "grad", "delta", "exp_avg", "exp_avg_sq")


# what torch.use_deterministic_algorithms asks of cuBLAS; torch reads it at
# the process's first cuBLAS call, so it is set before (chip_smoke.py's
# start, the card tests' import)
CUBLAS_DETERMINISTIC = ":4096:8"


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms(True), restored after."""
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in (":4096:8", ":16:8"):
        raise RuntimeError(f"set CUBLAS_WORKSPACE_CONFIG={CUBLAS_DETERMINISTIC} before the "
                           f"process's first cuBLAS call")
    mode = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(mode)


def _host_scalars(group: dict, schedule) -> Tuple[float, float]:
    step = group["step"] + 1
    step_size, decay = rectified_scalars(_f32(step), schedule(step), group["betas"],
                                         group["weight_decay"])
    return step_size.item(), decay.item()


class FrozenScalarRAdam(RAdam):
    """RAdam whose step size and decay are computed on the host, from its
    host count, and handed to the update as Python floats: a capture
    freezes them (a control of `verify`)."""

    def _scalars(self, group: dict) -> Tuple[float, float]:
        self.device_step += 1
        return _host_scalars(group, self.schedule)


class FrozenDecayRAdam(RAdam):
    """RAdam whose decay alone is a host float, frozen by a capture (a
    control of `verify` with a small error)."""

    def _scalars(self, group: dict) -> Tuple[torch.Tensor, float]:
        step_size, _ = super()._scalars(group)
        return step_size, _host_scalars(group, self.schedule)[1]


@dataclasses.dataclass
class Case:
    name: str
    steps: int
    stage: int = 4
    trimap: bool = False
    bf16: bool = False
    remat: bool = False
    stair_iters: Optional[int] = None       # a stair schedule over so many steps (None: cfg's)

    def config(self, base: Config) -> Config:
        cfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, stage=self.stage, bf16=self.bf16))
        if self.stair_iters:
            cfg.train = dataclasses.replace(cfg.train, lr_strategy="stair",
                                            total_epochs=self.stair_iters)
        return cfg

    def make_step(self, cfg: Config, graphs: bool):
        if self.trimap:
            return T.make_trimap_s1_train_step(cfg, graphs=graphs)
        return T.make_train_step(cfg, remat=self.remat, graphs=graphs)

    def reads_per_step(self, cfg: Config) -> int:
        if not (self.trimap or self.stage > 1):
            return 0
        return (cfg.train.frame_num - 1) * (2 if self.remat else 1)

    def merges_per_step(self, cfg: Config) -> Tuple[int, int]:
        """(reads merged in a cluster, through L2) of one step, as
        launch_geometry splits them."""
        if not self.reads_per_step(cfg):
            return 0, 0
        dt = torch.bfloat16 if self.bf16 else torch.float32
        h, w = cfg.train.train_input_size
        b, hw = cfg.train.batch_size, (h // 16) * (w // 16)
        table = ma.max_active_clusters(dt, 128 // cfg.model_scale, 512 // cfg.model_scale)
        kinds = [ma.launch_geometry(b, hw, t, 512 // cfg.model_scale, dt, table)[2:]
                 for t in range(1, cfg.train.frame_num)]
        per_pass = (sum(c > 1 for _, c in kinds), sum(n > c for n, c in kinds))
        return tuple(x * (2 if self.remat else 1) for x in per_pass)


def _norm_rel(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]) -> float:
    """||got - want|| / ||want|| over all tensors (0 where both are 0),
    summed in fp64."""
    norm2 = lambda x: float(torch.linalg.vector_norm(x, dtype=torch.float64)) ** 2
    d2 = sum(norm2(g - w) for g, w in zip(got, want))
    w2 = sum(norm2(w) for w in want)
    return (d2 / w2) ** 0.5 if w2 else (float("inf") if d2 else 0.0)


def _same_bits(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> bool:
    bits = lambda x: x.reshape(-1).view(torch.uint8)
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


class Nets:
    """One init of a case's networks, reloaded in place before each run;
    with a process group, this rank's copy (tools/ddp_check.py)."""

    def __init__(self, cfg: Config, seed: int, device, group=None):
        self.group = group
        self.state = T.init_train_state(cfg, seed=seed, device=device, group=group)
        self.init = [{k: v.clone() for k, v in net.state_dict().items()}
                     for net in (self.state.stm, self.state.fba)]

    def fresh(self, cfg: Config, optimizer: type) -> T.TrainState:
        stm, fba = self.state.stm, self.state.fba
        for net, sd in zip((stm, fba), self.init):
            net.load_state_dict(sd)
        opt = T.make_optimizer(cfg, stm, fba, iters_per_epoch=1)
        if optimizer is not RAdam:
            group = opt.param_groups[0]
            opt = optimizer(group["params"], lr=opt.schedule, weight_decay=group["weight_decay"])
        return T.TrainState(stm, fba, opt, group=self.group)


def _tensors(state) -> List[torch.Tensor]:
    """The parameters, then both moments, in the optimizer's order."""
    opt = state.optimizer
    params = opt.param_groups[0]["params"]
    return [*params, *(opt.state[p][k] for k in ("exp_avg", "exp_avg_sq") for p in params)]


@torch.no_grad()
def _save(state) -> tuple:
    return ([t.detach().clone() for t in _tensors(state)],
            state.optimizer.param_groups[0]["step"], state.step)


@torch.no_grad()
def _restore(state, saved: tuple) -> None:
    """`saved` copied back into the state's own tensors; RAdam puts the
    host's count back on the card at its next step."""
    tensors, count, step = saved
    for t, x in zip(_tensors(state), tensors):
        t.copy_(x)
    state.optimizer.param_groups[0]["step"], state.step = count, step


@torch.no_grad()
def _outcome(state, pre: tuple, loss: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
    """A step's loss, gradients (zeros where none), change to the
    parameters and the moments after it."""
    params = state.optimizer.param_groups[0]["params"]
    now, n = _tensors(state), len(params)
    return {"loss": [loss.detach().clone()],
            "grad": [torch.zeros_like(p) if p.grad is None else p.grad.clone() for p in params],
            "delta": [t - p for t, p in zip(now[:n], pre[0][:n])],
            "exp_avg": [t.clone() for t in now[n:2 * n]],
            "exp_avg_sq": [t.clone() for t in now[2 * n:]]}


def _read_counts() -> Tuple[int, Tuple[int, int]]:
    return ma.launches, (ma.cluster_launches, ma.l2_merge_launches)


def lockstep(case: Case, cfg: Config, nets: Nets, batches: Sequence, optimizer: type = RAdam,
             eager_first: int = 0, restore: Optional[Tuple[int, str]] = None,
             eager_runs: int = EAGER_RUNS) -> Dict:
    """The graphed run of `case`, each step beside `eager_runs` eager steps
    from the same state, under `deterministic` (see the module's
    docstring; with one, the eager step's repeatability goes unchecked).
    eager_first: so many steps of the run eager before the
    graphed ones; restore (i, path): restore_train_state(path) into the
    state after step i.  Returns per step the loss, whether the eager steps
    agreed and the graphed one equalled them bit for bit per quantity, the
    graphed one's distance from them, the hold; the kept metrics' check,
    read launches (all, and the graphed steps'), captures."""
    cfg = case.config(cfg)
    steps, kept = [], []
    graphed_reads, graphed_merges = 0, [0, 0]
    with deterministic():
        state = nets.fresh(cfg, optimizer)
        graphed, eager = case.make_step(cfg, True), case.make_step(cfg, False)
        state.optimizer.prepare()   # the moments, so that every step starts from saved ones
        ma.launches = ma.cluster_launches = ma.l2_merge_launches = 0
        for i in range(case.steps):
            pre = _save(state)
            outs = []
            for _ in range(eager_runs):
                state, metrics = eager(state, batches[i])
                outs.append(_outcome(state, pre, metrics["loss"]))
                _restore(state, pre)
            # the graphed step's `.grad` must be its own: none are left over
            state.optimizer.zero_grad(set_to_none=True)
            before = _read_counts()
            state, metrics = (eager if i < eager_first else graphed)(state, batches[i])
            after = _read_counts()
            graphed_reads += after[0] - before[0]
            graphed_merges = [g + a - b for g, a, b in zip(graphed_merges, after[1], before[1])]
            kept.append(metrics["loss"])
            got = _outcome(state, pre, metrics["loss"])
            steps.append(dict(
                loss=metrics["loss"].item(),
                repeatable={k: all(_same_bits(outs[0][k], o[k]) for o in outs[1:])
                            for k in QUANTITIES},
                equal={k: _same_bits(got[k], outs[0][k]) for k in QUANTITIES},
                distance={k: _norm_rel(got[k], outs[0][k]) for k in QUANTITIES},
                held=(None if state.optimizer.param_groups[0]["step"] >= MOVED
                      else not any(d.any() for d in got["delta"])),
                ranks_equal=(None if state.group is None
                             else D.ranks_equal(_tensors(state), state.group))))
            del pre, outs, got
            if restore and i + 1 == restore[0]:
                restore_train_state(restore[1], state)
        compiled = graphed.graphs
        out = dict(steps=steps, launches=ma.launches, eager_runs=eager_runs,
                   merges=(ma.cluster_launches, ma.l2_merge_launches),
                   graphed_launches=graphed_reads, graphed_merges=tuple(graphed_merges),
                   kept_equal=torch.stack(kept).cpu().tolist() == [s["loss"] for s in steps],
                   captures=compiled.captures, capture_s=compiled.capture_s)
        state.optimizer.zero_grad(set_to_none=True)
        del graphed, eager, state, compiled
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def verify(result: Dict) -> List[str]:
    """What `lockstep`'s graphed steps got wrong (see the module's
    docstring); [] if nothing."""
    bad = []
    for i, s in enumerate(result["steps"]):
        for k in QUANTITIES:
            if not s["repeatable"][k]:
                bad.append(f"{k} of step {i + 1}: the eager steps from one state differ")
            elif not s["equal"][k]:
                bad.append(f"{k} of step {i + 1}: graphed differs from eager by "
                           f"{s['distance'][k]:.3e}")
        if s["held"] is False:
            bad.append(f"step {i + 1} moved parameters in RAdam's hold")
        if s.get("ranks_equal") is False:
            bad.append(f"step {i + 1}: the ranks' parameters and moments differ")
    if not result["kept_equal"]:
        bad.append("the metrics kept across steps changed after their step")
    return bad


def timed(case: Case, cfg: Config, nets: Nets, batches: Sequence, graphs: bool) -> Dict:
    """The graphed or the eager step alone over the case's steps from the
    init, in the default mode: ms a step, host ms in the step call, reads,
    captures, peak memory, the losses."""
    cfg = case.config(cfg)
    state = nets.fresh(cfg, RAdam)
    step = case.make_step(cfg, graphs)
    out = dict(ms=[], host_ms=[], losses=[])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ma.launches = ma.cluster_launches = ma.l2_merge_launches = 0
    for batch in batches[:case.steps]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        out["host_ms"].append(1e3 * (time.perf_counter() - t0))
        ev[1].record()
        ev[1].synchronize()
        out["ms"].append(ev[0].elapsed_time(ev[1]))
        out["losses"].append(metrics["loss"].item())
    out.update(launches=ma.launches, merges=(ma.cluster_launches, ma.l2_merge_launches),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               step_ms=float(np.median(out["ms"][2:])),
               host_step_ms=float(np.median(out["host_ms"][2:])))
    if step.graphs is not None:
        out.update(captures=step.graphs.captures, capture_s=step.graphs.capture_s)
    state.optimizer.zero_grad(set_to_none=True)
    del step, state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def check_case(case: Case, cfg: Config, nets: Nets, batches: Sequence, control: bool = False,
               timing: bool = True) -> Dict:
    """The case in lockstep and its failures; where asked the graphed and
    the eager step timed alone (and their losses of the hold compared),
    and the frozen-scalar control captured in the hold, in lockstep over
    MOVED steps, and its failures."""
    out = dict(lockstep=lockstep(case, cfg, nets, batches))
    out["failures"] = verify(out["lockstep"])
    if timing:
        out.update(graphed=timed(case, cfg, nets, batches, True),
                   eager=timed(case, cfg, nets, batches, False))
        hold = min(case.steps, MOVED)
        if out["graphed"]["losses"][:hold] != out["eager"]["losses"][:hold]:
            out["failures"].append(f"timed: the losses of steps 1-{hold} differ, graphed "
                                   f"{out['graphed']['losses'][:hold]}, eager "
                                   f"{out['eager']['losses'][:hold]}")
    if control:
        short = dataclasses.replace(case, steps=MOVED)
        out["control"] = lockstep(short, cfg, nets, batches, optimizer=FrozenScalarRAdam)
        out["control_failures"] = verify(out["control"])
    return out


def summary(case: Case, result: Dict) -> str:
    """One case's lines: each timed run's ms, host ms, reads, captures and
    memory; the lockstep's per-step checks."""
    lines = [f"  {case.name}, {case.steps} steps:"]
    for name in ("eager", "graphed"):
        if name not in result:
            continue
        r = result[name]
        cap = (f", {r['captures']} capture(s) {r['capture_s']:.2f} s" if "captures" in r else "")
        lines.append(f"    {name}: {r['step_ms']:.1f} ms a step (CUDA events, median of steps "
                     f"3-{len(r['ms'])}), host {r['host_step_ms']:.2f} ms in the step call; "
                     f"reads {r['launches']}, merged in a cluster / through L2 {r['merges']}{cap}; "
                     f"peak memory {r['peak_gb']:.2f} GB allocated, {r['peak_reserved_gb']:.2f} "
                     f"GB reserved")
    lock = result["lockstep"]
    lines.append(f"    lockstep (deterministic algorithms, {EAGER_RUNS} eager steps from each "
                 f"state; reads {lock['launches']}, of the graphed steps "
                 f"{lock['graphed_launches']} merged {lock['graphed_merges']}): per step, "
                 f"eager repeatable / graphed equal bit for bit:")
    for i, s in enumerate(lock["steps"]):
        lines.append(f"      step {i + 1}: " + ", ".join(
            f"{k} {'yes' if s['repeatable'][k] else 'NO'}/"
            f"{'yes' if s['equal'][k] else 'NO %.2e' % s['distance'][k]}" for k in QUANTITIES))
    if "control" in result:
        lines.append(f"    frozen-scalar control rejected on {len(result['control_failures'])} "
                     f"counts, e.g. {result['control_failures'][:2]}")
    return "\n".join(lines)
