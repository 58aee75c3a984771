"""Where the time of the port's stage-4 stream goes, on one CUDA card.

    python -m otvm_tpu_torch.tools.profile_stream [--dtype bf16] [--frames 20]
        [--size 512] [--serving ROUNDS] [--out build/profile_stream.json]

Views of the full-width stream (random weights from a seed, a bank of at
most 5, memorize every 10th frame):
  * stage times: each step of eval_frame_step run alone on steady-state
    inputs (5 valid slots), median of CUDA-event times around each call,
    and the whole step replayed from its CUDA graph.  A stage whose host
    enqueue is slower than its device work shows its enqueue time here;
  * run_video eager (graphs=False) and graphed (models/graphs.py), each
    after a warm-up over the same frames (every graph captured): frames/s,
    the host's time in the step call a frame (median; where the device
    is the slower, the launch queue fills and this includes its wait),
    peak memory, and a torch.profiler trace: device time by kernel, device
    ops per frame, the device's busy share of the wall clock, and the
    host's busiest ops.
--serving R adds the ways to serve three clips (30, 17 and 30 frames):
run_video on each in turn, frame by frame; the same with chunk 8; and
MultiStreamEvaluator.run_videos on all three, round-robin, each graphed
(the evaluators' default on CUDA).  Frames/s on
the wall clock in R rounds of alternating turns (serial, multi, chunk 8,
chunk 8, multi, serial), then one trace of each.
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

from ..eval.runner import EvalProtocol, MultiStreamEvaluator, StreamingEvaluator
from ..kernels.memory_attn import memory_read
from ..models.graphs import FrameStepGraphs
from ..models.memory import update_bank
from ..models.otvm import eval_frame_step, init_models, make_eval_bank, make_trimap_features
from ..models.stm import normalize_image
from ..utils import trace


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
    graphs = FrameStepGraphs(stm, fba)
    graphed = graphs.bank(1, size, size, 5, dt)
    with torch.no_grad():
        k, v = stm.memorize(frame, tri[..., 1], tri[..., 2],
                            alpha=tri[..., 0], hidden=torch.zeros(1, size, size, 16,
                                                                  dtype=dt, device="cuda"))
        for i in range(5):
            bank = update_bank(bank, k, v, i == 0, True, 5)
            graphed = update_bank(graphed, k, v, i == 0, True, 5)
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
            "eval_frame_step replayed from its CUDA graph (the same)": lambda: graphs(
                graphed, frame, tri, False, False, True, max_memory_num=5),
        }
        return {name: _median_ms(fn, reps) for name, fn in stages.items()}


def _self_device_us(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def device_kernels(prof):
    """The device-side events of a torch.profiler run (kernels, copies),
    longest first, and their summed time in ms.  Host ops carry their
    kernels' time too and would count it twice; so would a user
    annotation's span on the device (the optimizer's step)."""
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and _self_device_us(e) > 0
               and not getattr(e, "is_user_annotation", False)]
    kernels.sort(key=_self_device_us, reverse=True)
    return kernels, sum(_self_device_us(e) for e in kernels) / 1e3


def trace(run, n_frames: int, top: int):
    """Profile run(), which serves n_frames frames."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = _self_device_us
    kernels, busy_ms = device_kernels(prof)
    host = [e for e in prof.key_averages()
            if not str(getattr(e, "device_type", "")).endswith("CUDA")]
    host.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_ops_per_frame": sum(e.count for e in kernels) / n_frames,
        "top": [{"name": e.key[:90], "device_ms": dev(e) / 1e3, "count": e.count}
                for e in kernels[:top]],
        # the port's own kernels (memory_read_*), wherever they rank
        "memory_kernels": [{"name": e.key[:90], "device_ms": dev(e) / 1e3, "count": e.count}
                           for e in kernels if "memory_read" in e.key],
        # host ops by their own CPU time (children excluded), per frame
        "host_top": [{"name": e.key[:90], "self_cpu_ms_per_frame":
                      e.self_cpu_time_total / 1e3 / n_frames, "count_per_frame": e.count / n_frames}
                     for e in host[:top]],
    }


def serving(stm_sd, fba_sd, dtype: str, clips, tri, rounds: int, top: int):
    """Three ways to serve `clips`, timed in alternating turns, then a
    trace of each (see the module's docstring)."""
    proto = dict(memory_max_num=5, memory_skip_frame=10, dtype=dtype)
    per_frame = MultiStreamEvaluator(stm_sd, fba_sd, EvalProtocol(**proto))
    chunked = StreamingEvaluator(stm_sd, fba_sd, EvalProtocol(chunk=8, **proto))
    n = sum(len(c) for c in clips)
    videos = [dict(frames=c, first_trimap=tri) for c in clips]

    def in_turn(ev):
        for c in clips:
            ev.run_video(c, tri)

    runs = {"serial": lambda: in_turn(per_frame), "multi": lambda: per_frame.run_videos(videos),
            "chunk8": lambda: in_turn(chunked)}
    fps = {name: [] for name in runs}
    for run in runs.values():                         # warm-up
        run()
    for _ in range(rounds):
        for name in ("serial", "multi", "chunk8", "chunk8", "multi", "serial"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            fps[name].append(n / (time.perf_counter() - t0))
    return {"frames": n, "frames_per_s": fps,
            "trace": {name: trace(run, n, top) for name, run in runs.items()}}


def host_step_ms(ev: StreamingEvaluator, frames, tri) -> float:
    """Median host time of the evaluator's step call over a run_video
    (its serve.step spans, utils/trace.py), the first frame left out."""
    was_on, kept = trace.enabled(), len(trace.records())
    trace.enable()
    try:
        ev.run_video(frames, tri)
    finally:
        if not was_on:
            trace.disable()
    times = [r.ms for r in trace.records()[kept:] if r.name == "serve.step"]
    return float(np.median(times[1:]))


def stream_view(ev: StreamingEvaluator, frames, tri, top: int):
    """frames/s, host ms a step, peak memory and a trace of run_video,
    after a warm-up over the same frames."""
    ev.run_video(frames, tri)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, _, fps = ev.run_video(frames, tri)
    return {"fps": fps, "host_step_ms": host_step_ms(ev, frames, tri),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "trace": trace(lambda: ev.run_video(frames, tri), len(frames), top)}


def random_clip(n: int, size: int, seed: int):
    rng = np.random.RandomState(seed)
    return [rng.rand(size, size, 3).astype(np.float32) for _ in range(n)]


def _print_trace(t):
    print(f"  trace: wall {t['wall_ms']:.1f} ms, device busy {t['device_busy_ms']:.1f} ms "
          f"({t['device_busy_share']:.1%}), {t['device_ops_per_frame']:.0f} device ops/frame")
    for e in t["top"]:
        print(f"  {e['device_ms']:9.3f} ms {e['count']:6d}x  {e['name']}")
    for e in t["memory_kernels"]:
        print(f"  memory read: {e['device_ms']:9.3f} ms {e['count']:6d}x  {e['name']}")
    for e in t["host_top"]:
        print(f"  host {e['self_cpu_ms_per_frame']:8.3f} ms/frame {e['count_per_frame']:7.1f}x  "
              f"{e['name']}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "fp32"))
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--serving", type=int, default=0, metavar="ROUNDS")
    ap.add_argument("--out", default="build/profile_stream.json")
    args = ap.parse_args()

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    stm, fba = init_models(seed=0, stage=4)
    frames = random_clip(args.frames, args.size, 0)
    tri = np.zeros((args.size, args.size, 3), np.float32)
    s = args.size
    tri[..., 0] = 1.0
    tri[s // 4:-s // 4, s // 4:-s // 4] = (0, 1, 0)
    tri[3 * s // 8:-3 * s // 8, 3 * s // 8:-3 * s // 8] = (0, 0, 1)
    result = {"card": card, "dtype": args.dtype, "size": args.size, "frames": args.frames}
    for name, graphs in (("eager", False), ("graphs", True)):
        ev = StreamingEvaluator(stm.state_dict(), fba.state_dict(),
                                EvalProtocol(memory_max_num=5, memory_skip_frame=10,
                                             dtype=args.dtype), graphs=graphs)
        view = result[name] = stream_view(ev, frames, tri, args.top)
        print(f"card: {card}; {args.dtype} {args.size}x{args.size}, {args.frames} frames, "
              f"{name}: {view['fps']:.2f} frames/s, host {view['host_step_ms']:.3f} ms a step, "
              f"peak memory {view['peak_gb']:.2f} GB")
        _print_trace(view["trace"])
    result["stage_ms"] = stage_times(ev, args.size, args.reps)
    for name, ms in result["stage_ms"].items():
        print(f"  {ms:9.3f} ms  {name}")
    if args.serving:
        del ev
        clips = [random_clip(n, args.size, seed) for n, seed in ((30, 0), (17, 1), (30, 0))]
        sv = result["serving"] = serving(stm.state_dict(), fba.state_dict(), args.dtype, clips,
                                         tri, args.serving, args.top)
        print(f"serving {sv['frames']} frames of 3 clips, {args.dtype}, frames/s by turn:")
        for name, fps_ in sv["frames_per_s"].items():
            print(f"  {name:7s} " + " ".join(f"{x:.3f}" for x in fps_)
                  + f"  (median {np.median(fps_):.3f})")
        for name, t in sv["trace"].items():
            print(f"  {name}:")
            _print_trace(t)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
