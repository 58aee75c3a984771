"""Stream cells: whole clips served back to back through the port's
`StreamingEvaluator.run_video` (the joint stage-4 network) or
`TrimapEvaluator.run_video` (the stage-1 STM alone), graphed as the port
serves on CUDA.

Set-up: import, the read's library, weights drawn on the card from the
seed and the evaluator built on them, the traffic, and a warm-up clip just
long enough to meet every graph key that the window's clips meet, so the
window captures nothing.  Window: clips until `seconds` have passed, a
clip that starts inside it counted to its end; stream_fps is all their
frames over all that time.  Only the clip last served is kept for the
check: a clip's outputs go before the next clip is served.  With a trace,
the window's first clip is profiled.  Afterwards the window's last clip is
judged (checks/stream.py)."""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from ..checks import stream as checks
from ..counts import flops as fc
from ..counts import peaks
from ..counts.read import read_least_s
from ..harness import profiling
from ..harness.clock import SetupClock
from ..harness.main import verdict
from ..harness.traffic import StreamTraffic
from ..reference import nets, stream as rs
from ..reference.precision import tf32
from ..reference.weights import seeded_state

WARMUP_CLIP = 1 << 20         # the warm-up clip's index: never a window clip's


def graph_keys(n: int, h: int, w: int, joint: bool):
    """The graph keys a clip of n frames meets (the port's models/graphs.py
    keys a joint frame by (count, memorize, last), a trimap frame by
    (count, memorize)); a first frame runs eagerly."""
    flags, max_num = rs.schedule(n, h, w)
    slots = rs.slot_frames(flags, max_num, joint)
    keys = set()
    for i, (first, memorize, last) in enumerate(flags):
        if not first:
            keys.add((len(slots[i]), memorize and not last, last) if joint
                     else (len(slots[i]), memorize))
    return keys


def warmup_frames(n: int, h: int, w: int, joint: bool) -> int:
    """The shortest clip that meets every key of an n-frame clip."""
    need = graph_keys(n, h, w, joint)
    return next(m for m in range(2, n + 1) if graph_keys(m, h, w, joint) >= need)


def judged_frames(n: int, h: int, w: int, joint: bool, params: dict, seed: int) -> List[int]:
    """The frames of the last clip that the check reads: joint, every frame
    but the last; trimap, `judged_frames` drawn from the seed, the first
    and the last, and the frames their banks hold."""
    if joint:
        return checks.joint_judged(n)
    return checks.trimap_frames_needed(n, h, w, drawn_frames(n, params, seed))


def drawn_frames(n: int, params: dict, seed: int) -> List[int]:
    """The trimap frames judged: `judged_frames` drawn from the seed, the
    first and the last."""
    rng = np.random.default_rng([int(seed), 7])
    drawn = rng.choice(np.arange(1, n - 1), size=params["judged_frames"], replace=False)
    return sorted({0, n - 1, *map(int, drawn)})


def _evaluator(cell, stm_state, fba_state, device):
    from otvm_tpu_torch.eval.runner import EvalProtocol, StreamingEvaluator, TrimapEvaluator

    c, t = cell.config, cell.traffic
    protocol = EvalProtocol(memory_max_num=c["memory_max_num"],
                            memory_skip_frame=c["memory_skip_frame"], dtype=t["dtype"],
                            stage=c["stage"], arch=c["fba_arch"], scale=c.get("model_scale", 1))
    if c["network"] == "joint":
        return StreamingEvaluator(stm_state, fba_state, protocol, device=device)
    return TrimapEvaluator(stm_state, protocol, device=device)


def _final_bank(ev, h: int, w: int, count: int, dtype):
    """The served bank's valid slots as the last clip left them, where the
    evaluator keeps it (its graphs' static bank); None on the eager path."""
    if ev.step_graphs is None:
        return None
    lw, uw, lh, uh = rs.pad_amounts(h, w)
    bank = ev.step_graphs.bank(1, h + lh + uh, w + lw + uw, ev.protocol.memory_max_num, dtype)
    return bank.keys[:, :count].clone(), bank.values[:, :count].clone()


def _serve(ev, joint: bool, frames, tri):
    """One clip: (alphas or None, trimaps)."""
    if joint:
        alphas, trimaps, _ = ev.run_video(frames, tri)
        return alphas, trimaps
    trimaps, _ = ev.run_video(frames, tri)
    return None, trimaps


def _trace_context(cell, summary: Dict, n: int, h: int, w: int, joint: bool, ev) -> Dict:
    """What the stream's per-layer metrics read: the traced clip's
    summary, its FLOPs and the least time of its reads."""
    dtype = cell.traffic["dtype"]
    lw, uw, lh, uh = rs.pad_amounts(h, w)
    hp, wp = h + lh + uh, w + lw + uw
    scale = cell.config.get("model_scale", 1)
    parts = fc.stream_parts(cell.config["network"], hp, wp, scale)
    flags, max_num = rs.schedule(n, h, w)
    slots = rs.slot_frames(flags, max_num, joint)
    hw = (hp // 16) * (wp // 16)
    ck, cv = nets.KEY_DIM // scale, nets.VAL_DIM // scale
    flops = read_s = 0.0
    for i, (first, memorize, last) in enumerate(flags):
        flops += parts.get("fba", 0)
        if not (joint and last):
            flops += parts["memorize"]
        if not first:
            t = len(slots[i])
            flops += parts["segment"] + 2.0 * 1 * hw * (t * hw) * (ck + cv)
            read_s += read_least_s(1, hw, t, ck, cv, dtype)
    return dict(summary, flops=flops, peak_flops=peaks.peak_flops(dtype), read_least_s=read_s,
                counters={"capture_s": ev.step_graphs.capture_s if ev.step_graphs else None})


def run(cell, seed: int, seconds: float, trace: bool, t_start: float, device=None) -> Dict:
    clock = SetupClock(t_start)
    from otvm_tpu_torch.kernels import memory_attn as ma

    clock.part("import")
    device = torch.device(device or "cuda")
    on_card = device.type == "cuda"
    if on_card:
        ma.build()
        clock.part("library")
    params, joint = cell.traffic, cell.config["network"] == "joint"
    ref = nets.build(cell.config["network"], cell.config.get("model_scale", 1))
    for m in ref.values():
        m.to("meta")
    states = {k: seeded_state(m, seed + j, device) for j, (k, m) in enumerate(ref.items())}
    ev = _evaluator(cell, states["stm"], states.get("fba"), device)
    del states                      # drawn again for the check: the peak is the program's
    clock.part("weights")
    traffic = StreamTraffic(params, seed, device)
    n, (h, w) = traffic.n, traffic.frames[0].shape[:2]
    clock.part("traffic")
    frames, tri = traffic.clip(WARMUP_CLIP)
    m = warmup_frames(n, h, w, joint)
    _serve(ev, joint, frames[:m], tri)
    if on_card:
        torch.cuda.synchronize(device)
    clock.part("warmup")
    if ev.step_graphs is not None:
        print(f"setup captures: {ev.step_graphs.captures} graphs in {ev.step_graphs.capture_s:.3f}"
              f" s of the warm-up's {m} frames", file=sys.stderr, flush=True)
    setup_s = clock.total()

    keep = judged_frames(n, h, w, joint, params, seed)
    done, failed, k, summary, last, clip_s = 0, 0, 0, None, None, []
    t0 = time.perf_counter()
    while True:
        frames, tri = traffic.clip(k)
        last = None                 # the previous clip's outputs: only the last clip is judged
        t_clip = time.perf_counter()
        if trace and k == 0:
            (alphas, trimaps), summary = profiling.traced(
                lambda: _serve(ev, joint, frames, tri), device)
        else:
            alphas, trimaps = _serve(ev, joint, frames, tri)
        clip_s.append(time.perf_counter() - t_clip)
        failed += n - len(trimaps)
        done += n
        last = (frames, tri, {i: ((alphas[i], trimaps[i]) if joint else trimaps[i])
                              for i in keep})
        del alphas, trimaps
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if on_card:
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    notes = ["clip fps: " + " ".join(f"{n / s:.4f}" for s in clip_s)]
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    flags, max_num = rs.schedule(n, h, w)
    count = len(rs.slot_frames(flags, max_num, joint)[n - 1])
    bank = _final_bank(ev, h, w, count, ev.dtype) if joint else None
    trace_ctx = _trace_context(cell, summary, n, h, w, joint, ev) if trace else None
    del ev
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    stats = judge(cell, seed, last, bank, n, h, w, joint, device)
    return {"end_to_end": {"setup_s": setup_s, "stream_fps": done / elapsed},
            "setup_parts": clock.parts, "attempted": done, "failed": failed,
            "memory_peak_bytes": peak, "notes": notes, **verdict(cell, stats),
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "trace": trace_ctx}


def judge(cell, seed: int, last, bank, n: int, h: int, w: int, joint: bool, device):
    """The reference (fp32, TF32 off), on the run's seeded weights, on the
    window's last clip: {number: value}."""
    frames, tri, got = last
    ref = nets.build(cell.config["network"], cell.config.get("model_scale", 1))
    for j, (k, m) in enumerate(ref.items()):
        m.load_state_dict(seeded_state(m, seed + j, device))
        m.to(device).eval()
    with tf32(False):
        if joint:
            return checks.check_joint(ref, frames, tri, got, bank, device)
        return checks.check_trimap(ref, frames, tri, got, drawn_frames(n, cell.traffic, seed), device)
