"""Where the time of the port's stage-4 train step goes, on one CUDA card.

    python -m otvm_tpu_torch.tools.profile_train [--dtype fp32|bf16] [--eager]
        [--out build/profile_train.json]

The train step of `make_train_step` at config.py's crop, batch and clip
length (random weights from a seed, `seeded_batches`), fp32 with TF32 off
or bf16 compute with fp32 masters, from CUDA graphs (train/graphs.py) and
eagerly, side by side (`--eager`: eagerly alone), each mode from the same
init:
  * ms a step: median of CUDA-event times around each of 4 steps, after
    two warm-up steps (graphed: the eager first step, then the capture);
    the host's ms in the step call; the peak memory allocated and
    reserved over all the mode's steps; the captures and their seconds;
  * a torch.profiler trace of one step: device time by kernel, device ops
    a step, the device's busy share of the step's wall clock, and the
    memory read's share: its kernels (memory_read_*) and its backward
    (the autograd node MemoryReadBackward, with every kernel it launched);
    its Chrome trace goes to <out without .json>_<mode>_trace/trace.json.
`chip_smoke.py` phase 6 makes its batches and times and profiles its steps
with the same functions.  Needs a CUDA card; it does not run on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict

import numpy as np
import torch

from ..config import Config, get_cfg_defaults
from ..data.loader import encode_wire
from ..train.optim import RAdam
from ..train.trainer import make_train_step
from ..utils.logging import profile_trace
from .profile_stream import device_kernels

WARMUP, TIMED = 2, 4


def seeded_batches(cfg: Config, n: int, seed: int):
    """n clips of cfg.train's batch, frames and crop, in VM108Train's layout
    through encode_wire: smooth fg and bg (a coarse random grid, bilinearly
    upsampled), an alpha with solid 0 and 1 regions and a soft band
    between, and the trimap it gives (bg where alpha is 0, fg where 1,
    unknown between)."""
    b, s = cfg.train.batch_size, cfg.train.frame_num
    h, w = cfg.train.train_input_size
    rng = np.random.RandomState(seed)

    def smooth(c):
        grid = torch.from_numpy(rng.rand(b * s, c, 9, 9).astype(np.float32))
        up = torch.nn.functional.interpolate(grid, size=(h, w), mode="bilinear",
                                             align_corners=True)
        return up.permute(0, 2, 3, 1).reshape(b, s, h, w, c).numpy()

    batches = []
    for _ in range(n):
        alpha = np.clip(3.0 * smooth(1) - 1.0, 0.0, 1.0)
        label = np.where(alpha[..., 0] == 0.0, 0, np.where(alpha[..., 0] == 1.0, 2, 1))
        batches.append(encode_wire(dict(fg=smooth(3), bg=smooth(3), alpha=alpha,
                                        tri=np.eye(3, dtype=np.float32)[label])))
    return batches


def timed_step(step, state, batch):
    """One train step -> (state, metrics, CUDA-event ms, wall ms to the end
    of its device work, host ms in the step call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    state, metrics = step(state, batch)
    t1 = time.perf_counter()
    end.record()
    end.synchronize()
    return (state, metrics, start.elapsed_time(end), 1e3 * (time.perf_counter() - t0),
            1e3 * (t1 - t0))


def profile_step(step, state, batch, trace_dir: str):
    """One train step under torch.profiler (utils/logging.py profile_trace,
    its Chrome trace written to <trace_dir>/trace.json) -> (state, trace
    summary)."""
    torch.cuda.synchronize()
    with profile_trace(trace_dir, enabled=True) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, busy_ms = device_kernels(prof)
    dev = lambda e, kind: getattr(e, f"{kind}device_time_total",
                                  getattr(e, f"{kind}cuda_time_total", 0)) / 1e3
    # the Function's backward node and the engine's wrapper around it nest:
    # the larger is the node with every kernel it launched
    bwd = [dev(e, "") for e in prof.key_averages() if "MemoryReadBackward" in e.key]
    return state, {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "device_ops": sum(e.count for e in kernels),
        "read_ms": sum(dev(e, "self_") for e in kernels if "memory_read" in e.key),
        "read_backward_ms": max(bwd) if bwd and max(bwd) > 0 else None,
        "top": [{"name": e.key[:90], "device_ms": dev(e, "self_"), "count": e.count}
                for e in kernels[:15]],
    }


def profile_mode(cfg: Config, nets, graphs: bool, batches, out: str) -> Dict:
    """One mode's numbers: WARMUP steps (graphed: the warm-up and the
    capture), TIMED timed steps, one profiled step; peak memory over all."""
    state = nets.fresh(cfg, RAdam)
    step = make_train_step(cfg, graphs=graphs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for batch in batches[:WARMUP]:
        state, _ = step(state, batch)
    times, host = [], []
    for batch in batches[WARMUP:-1]:
        state, _, ms, _, host_ms = timed_step(step, state, batch)
        times.append(ms)
        host.append(host_ms)
    trace_dir = os.path.splitext(out)[0] + ("_graphed" if graphs else "_eager") + "_trace"
    state, trace = profile_step(step, state, batches[-1], trace_dir)
    result = {"step_ms": float(np.median(times)), "step_ms_each": times,
              "host_ms": float(np.median(host)),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "peak_reserved_gb": torch.cuda.max_memory_reserved() / 1e9, "trace": trace}
    if step.graphs is not None:
        result.update(captures=step.graphs.captures, capture_s=step.graphs.capture_s)
    state.optimizer.zero_grad(set_to_none=True)         # the graph pool's gradients
    del step, state
    torch.cuda.empty_cache()
    return result


def main():
    from .train_graphs_check import Nets        # it imports this module's seeded_batches

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="fp32", choices=("fp32", "bf16"))
    ap.add_argument("--eager", action="store_true",
                    help="the eager step alone (default: graphed and eager side by side)")
    ap.add_argument("--out", default="build/profile_train.json")
    args = ap.parse_args()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = get_cfg_defaults()
    cfg.train.stage, cfg.train.bf16 = 4, args.dtype == "bf16"
    nets = Nets(cfg, seed=0, device="cuda")
    batches = seeded_batches(cfg, WARMUP + TIMED + 1, seed=1)
    (h, w), b, s = cfg.train.train_input_size, cfg.train.batch_size, cfg.train.frame_num
    result = {"card": card, "dtype": args.dtype, "size": [h, w], "batch": b, "frames": s}
    print(f"card: {card}; stage-4 train step, {args.dtype}, {h}x{w}, B {b}, S {s}")
    for mode in (("eager",) if args.eager else ("graphed", "eager")):
        r = result[mode] = profile_mode(cfg, nets, mode == "graphed", batches, args.out)
        trace = r["trace"]
        cap = (f"; {r['captures']} capture, {r['capture_s']:.2f} s" if "captures" in r else "")
        print(f"{mode}: {r['step_ms']:.1f} ms a step (CUDA events, median of {TIMED}), host "
              f"{r['host_ms']:.2f} ms in the step call, peak memory {r['peak_gb']:.2f} GB "
              f"allocated, {r['peak_reserved_gb']:.2f} GB reserved{cap}")
        print(f"  trace: wall {trace['wall_ms']:.1f} ms, device busy {trace['device_busy_ms']:.1f} "
              f"ms ({trace['device_busy_share']:.1%}), {trace['device_ops']} device ops; memory "
              f"read: kernels {trace['read_ms']:.3f} ms, backward {trace['read_backward_ms']} ms")
        for e in trace["top"]:
            print(f"  {e['device_ms']:9.3f} ms {e['count']:6d}x  {e['name']}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
