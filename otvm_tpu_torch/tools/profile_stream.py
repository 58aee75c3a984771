"""Where the time of the port's stage-4 stream goes, on one CUDA card.

    python -m otvm_tpu_torch.tools.profile_stream [--dtype bf16] [--frames 20]
        [--size 512] [--out build/profile_stream.json]

Two views of the full-width stream (random weights from a seed, a bank of
at most 5, memorize every 10th frame):
  * stage times: each step of eval_frame_step run alone on steady-state
    inputs (5 valid slots), median of CUDA-event times around each call.
    A stage whose host enqueue is slower than its device work shows its
    enqueue time here;
  * a torch.profiler trace of run_video: device time by kernel, launches
    per frame, and the device's busy share of the wall clock.
Needs a CUDA card; it does not run on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from ..eval.runner import EvalProtocol, StreamingEvaluator
from ..kernels.memory_attn import memory_read
from ..models.memory import update_bank
from ..models.otvm import eval_frame_step, init_models, make_eval_bank, make_trimap_features
from ..models.stm import normalize_image


def _median_ms(fn, reps):
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def stage_times(ev: StreamingEvaluator, size: int, reps: int):
    stm, fba, dt = ev.stm, ev.fba, ev.dtype
    gen = torch.Generator(device="cuda").manual_seed(0)
    frame = torch.rand(1, size, size, 3, generator=gen, device="cuda").to(dt)
    tri = torch.softmax(torch.randn(1, size, size, 3, generator=gen, device="cuda"), -1).to(dt)
    bank = make_eval_bank(1, size, size, 5, dtype=dt)
    with torch.no_grad():
        k, v = stm.memorize(frame, tri[..., 1], tri[..., 2],
                            alpha=tri[..., 0], hidden=torch.zeros(1, size, size, 16,
                                                                  dtype=dt, device="cuda"))
        for i in range(5):
            bank = update_bank(bank, k, v, i == 0, True, 5)
        feats8, _ = make_trimap_features(tri)
        x11 = torch.cat([normalize_image(frame), feats8], -1)
        _, hid, rout7, _ = fba(x11, frame, feats8[..., -2:])
        q = torch.randn(1, (size // 16) ** 2, stm.key_dim, generator=gen, device="cuda").to(dt)
        mask = bank.slot_mask
        stages = {
            "memory_read (kernel)": lambda: memory_read(q, bank.keys, bank.values, mask),
            "STM.segment (incl. memory_read)": lambda: stm.segment(
                frame, bank.keys, bank.values, mask),
            "make_trimap_features (argmax, JFA EDT, clicks)": lambda: make_trimap_features(tri),
            "FBA (encoder, decoder, refinement)": lambda: fba(x11, frame, feats8[..., -2:]),
            "STM.memorize": lambda: stm.memorize(frame, tri[..., 1], tri[..., 2],
                                                 alpha=rout7[..., 0], hidden=hid),
            "eval_frame_step (steady state, no memorize)": lambda: eval_frame_step(
                stm, fba, bank, frame, tri, False, False, True, max_memory_num=5),
        }
        return {name: _median_ms(fn, reps) for name, fn in stages.items()}


def trace(ev: StreamingEvaluator, frames, tri, top: int):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ev.run_video(frames, tri)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    # device-side events only (kernels, copies); host ops carry their
    # kernels' time too and would count it twice
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and dev(e) > 0]
    busy_ms = sum(dev(e) for e in kernels) / 1e3
    kernels.sort(key=dev, reverse=True)
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_ops_per_frame": sum(e.count for e in kernels) / len(frames),
        "top": [{"name": e.key[:90], "device_ms": dev(e) / 1e3, "count": e.count}
                for e in kernels[:top]],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "fp32"))
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default="build/profile_stream.json")
    args = ap.parse_args()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    stm, fba = init_models(seed=0, stage=4)
    ev = StreamingEvaluator(stm.state_dict(), fba.state_dict(),
                            EvalProtocol(memory_max_num=5, memory_skip_frame=10,
                                         dtype=args.dtype))
    rng = np.random.RandomState(0)
    frames = [rng.rand(args.size, args.size, 3).astype(np.float32) for _ in range(args.frames)]
    tri = np.zeros((args.size, args.size, 3), np.float32)
    s = args.size
    tri[..., 0] = 1.0
    tri[s // 4:-s // 4, s // 4:-s // 4] = (0, 1, 0)
    tri[3 * s // 8:-3 * s // 8, 3 * s // 8:-3 * s // 8] = (0, 0, 1)
    ev.run_video(frames[:12], tri)                    # warm-up

    _, _, fps = ev.run_video(frames, tri)
    result = {"card": card, "dtype": args.dtype, "size": args.size, "frames": args.frames,
              "fps": fps, "stage_ms": stage_times(ev, args.size, args.reps),
              "trace": trace(ev, frames, tri, args.top)}
    print(f"card: {card}; {args.dtype} {args.size}x{args.size}, {args.frames} frames: "
          f"{fps:.2f} frames/s")
    for name, ms in result["stage_ms"].items():
        print(f"  {ms:9.3f} ms  {name}")
    t = result["trace"]
    print(f"  trace: wall {t['wall_ms']:.1f} ms, device busy {t['device_busy_ms']:.1f} ms "
          f"({t['device_busy_share']:.1%}), {t['device_ops_per_frame']:.0f} device ops/frame")
    for e in t["top"]:
        print(f"  {e['device_ms']:9.3f} ms {e['count']:6d}x  {e['name']}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
