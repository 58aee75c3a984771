"""Train cells: the port's stage-4 train step, `make_train_step(cfg,
graphs=True)` on `init_train_state`, one process on one chip or one NCCL
rank a chip, each replaying its CUDA graph.

Set-up: import, the read's library, the state (the port's init, then the
weights drawn on the card from the seed loaded into it), the traffic's
8-bit global batches (each rank takes its rows), and the first steps
through the window's own call: step 1 eager, step 2 captured, then
replays.  The first `check_steps` steps, on batches that all differ, are
the ones the check follows; three more give the window's length in steps.
Window: that many steps, ms a step over all of them (at several chips,
rank 0's clock; the ranks run in lockstep).  With a trace, three steps
after the window are profiled.  Afterwards the same state's readings are
held to the reference's (checks/train.py) on rank 0."""
from __future__ import annotations

import gc
import math
import os
import sys
import time
from typing import Dict

import torch

from ..checks import train as checks
from ..counts import flops as fc
from ..counts import peaks
from ..harness import profiling
from ..harness.clock import SetupClock
from ..harness.main import forbidden_modules, verdict
from ..harness.traffic import train_batches
from ..reference import nets
from ..reference.weights import seeded_state

ESTIMATE_STEPS = 3


def _config(cell):
    from otvm_tpu_torch.config import Config

    c, t = cell.config, cell.traffic
    cfg = Config()
    cfg.train.stage = c["stage"]
    cfg.train.bf16 = t["dtype"] == "bf16"
    cfg.train.batch_size = t["batch"]
    cfg.train.frame_num = t["frames"]
    cfg.train.train_input_size = (t["height"], t["width"])
    cfg.train.base_lr = c["base_lr"]
    cfg.train.weight_decay = c["weight_decay"]
    cfg.train.total_epochs = c["total_epochs"]
    cfg.alpha.arch = c["fba_arch"]
    cfg.stm_norm = c["stm_norm"]
    cfg.model_scale = c.get("model_scale", 1)
    return cfg


def _named(state):
    return [(f"{k}.{n}", p) for k, net in (("stm", state.stm), ("fba", state.fba))
            for n, p in net.named_parameters()]


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, device=None) -> Dict:
    if cell.chips == 1:
        return rank_main(cell, seed, seconds, trace, t_start, device)
    from otvm_tpu_torch.parallel import dist as D

    outs = D.spawn(rank_main, cell.chips, cell, seed, seconds, trace, t_start, device,
                   timeout=340.0)
    out = outs[0]
    out["memory_peak_bytes"] = max(o["memory_peak_bytes"] for o in outs)
    out["forbidden"] = sorted({m for o in outs for m in o["forbidden"]})
    if trace:
        out["trace"]["busy_s"] = sum(o["busy_s"] for o in outs) / len(outs)
    return out


def rank_main(cell, seed: int, seconds: float, trace: bool, t_start: float, device=None):
    world = cell.chips
    from otvm_tpu_torch.kernels import memory_attn as ma
    from otvm_tpu_torch.parallel import dist as D
    from otvm_tpu_torch.train.trainer import init_train_state, make_train_step

    rank = int(os.environ.get("RANK", "0"))
    clock = SetupClock(t_start, f"rank {rank} " if world > 1 else "")
    clock.part("import")
    device = (D.init_distributed(device or "cuda") if world > 1
              else torch.device(device or "cuda"))
    group = D.data_group()
    on_card = device.type == "cuda"
    if on_card:
        ma.build()
        clock.part("library")
    cfg, t = _config(cell), cell.traffic
    state = init_train_state(cfg, seed=0, device=device, group=group)
    ref = nets.build("joint", cfg.model_scale)
    for m in ref.values():
        m.to("meta")
    draw = lambda: {k: seeded_state(m, seed + j, device) for j, (k, m) in enumerate(ref.items())}
    states = draw()
    state.stm.load_state_dict(states["stm"])
    state.fba.load_state_dict(states["fba"])
    if group is not None and not D.ranks_equal(list(states["stm"].values()), group):
        raise RuntimeError("the ranks drew different weights from one seed")
    del states                      # drawn again below: the peak is the program's
    step = make_train_step(cfg, graphs=on_card)
    clock.part("weights")
    batches = train_batches(t, seed)
    rows = slice(rank * t["batch"] // world, (rank + 1) * t["batch"] // world)
    mine = [{k: v[rows] for k, v in b.items()} for b in batches]
    clock.part("traffic")

    named = _named(state)
    names = [n for n, _ in named]
    losses = []
    for i in range(t["check_steps"]):
        state, metrics = step(state, mine[i])
        losses.append(metrics["loss"].detach().clone())
        if i == 0:                  # the first moment after one step is (1 - beta1) g
            beta1 = state.optimizer.param_groups[0]["betas"][0]
            grad1 = checks.leaf_norms([state.optimizer.state[p]["exp_avg"] / (1 - beta1)
                                       for _, p in named])
    states = draw()
    start = [states[n.split(".", 1)[0]][n.split(".", 1)[1]] for n in names]
    change = checks.leaf_norms([p.detach() - q for (_, p), q in zip(named, start)])
    del start, states
    lockstep = (0.0 if group is None or D.ranks_equal([p for _, p in named], group) else 1.0)
    if group is not None:
        stacked = torch.stack(losses)
        torch.distributed.all_reduce(stacked, group=group)
        losses = list(stacked / world)
    losses = [float(x) for x in losses]
    k = t["check_steps"]
    if on_card:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for j in range(ESTIMATE_STEPS):
        state, _ = step(state, mine[(k + j) % len(mine)])
    if on_card:
        torch.cuda.synchronize(device)
    est = (time.perf_counter() - t0) / ESTIMATE_STEPS
    n = torch.tensor([max(3, math.ceil(seconds / est))], device=device)
    if group is not None:
        torch.distributed.broadcast(n, 0, group=group)
    n, k = int(n), k + ESTIMATE_STEPS
    clock.part("steps")
    setup_s = clock.total()

    window_losses = []
    t0 = time.perf_counter()
    for j in range(n):
        state, metrics = step(state, mine[(k + j) % len(mine)])
        window_losses.append(metrics["loss"].detach().clone())
    if on_card:
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    k += n
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    summary = None
    if trace:
        def three():
            for j in range(3):
                step(state, mine[(k + j) % len(mine)])
        _, summary = profiling.traced(three, device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    out = {"memory_peak_bytes": peak, "forbidden": forbidden_modules(sys.modules),
           "busy_s": summary["busy_s"] if summary else None}
    del state, step, named, metrics
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if rank != 0:
        return out

    trace_ctx = None
    if trace:
        flops = 3 * fc.train_step_flops(t["batch"], t["frames"], t["height"], t["width"],
                                        cfg.model_scale)
        trace_ctx = dict(summary, flops=flops, peak_flops=world * peaks.peak_flops(t["dtype"]),
                         counters={})
    got = dict(names=names, losses=losses, grad1=grad1, change=change)
    stats = checks.check(cell, draw(), batches[:t["check_steps"]], got, device)
    if world > 1:
        stats["ranks_differ"] = lockstep
    out.update({
        "end_to_end": {"setup_s": setup_s, "train_step_ms": 1e3 * elapsed / n},
        "setup_parts": clock.parts, "attempted": n, "failed": failed, **verdict(cell, stats),
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu", "trace": trace_ctx})
    return out
