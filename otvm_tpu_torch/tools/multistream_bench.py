"""Multi-stream serving rate: N streams through MultiStreamEvaluator on one
card, the port's scripts/multistream_bench.py.

    python -m otvm_tpu_torch.tools.multistream_bench [--streams 4]
        [--res 512x512] [--frames 40] [--dtype bf16|fp32] [--device cuda|cpu]

The stage-4 model at full width with random weights from seed 0; each
stream cycles 4 seeded random frames (every frame still goes up to the
card as uint8: wire-inclusive, as serving is) with the nested-box first
trimap, uint8 outputs (wire_u8_out).  A warm-up over clips of the same
length first (kernel build; on CUDA every graph the timed run replays,
models/graphs.py).  Prints one JSON line: the
aggregate frames/s over the wall clock of run_videos, per stream, and the
device it ran on.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import resolve_device
from ..eval.runner import EvalProtocol, MultiStreamEvaluator
from ..models.otvm import init_models


def first_trimap(h: int, w: int) -> np.ndarray:
    tri = np.zeros((h, w, 3), np.float32)
    tri[..., 0] = 1.0
    tri[h // 4:-h // 4, w // 4:-w // 4] = (0, 1, 0)
    tri[3 * h // 8:-3 * h // 8, 3 * w // 8:-3 * w // 8] = (0, 0, 1)
    return tri


def make_video(seed: int, n: int, h: int, w: int):
    """n frames cycling 4 seeded random ones (bounded host memory; each
    frame is uploaded anew all the same)."""
    rng = np.random.RandomState(seed)
    unique = [rng.rand(h, w, 3).astype(np.float32) for _ in range(4)]
    return dict(frames=[unique[i % 4] for i in range(n)], first_trimap=first_trimap(h, w))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--res", default="512x512", help="HxW")
    ap.add_argument("--frames", type=int, default=40, help="frames a stream")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "fp32"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    h, w = (int(x) for x in args.res.split("x"))
    device = resolve_device(args.device)

    stm, fba = init_models(seed=0, stage=4)
    ev = MultiStreamEvaluator(stm.state_dict(), fba.state_dict(),
                              EvalProtocol(dtype=args.dtype, wire_u8_out=True), device=device)
    t0 = time.perf_counter()
    ev.run_videos([make_video(99, args.frames, h, w) for _ in range(args.streams)])
    warmup_s = time.perf_counter() - t0
    results, fps = ev.run_videos([make_video(s, args.frames, h, w) for s in range(args.streams)])
    assert all(len(alphas) == args.frames for alphas, _ in results)
    assert all(np.isfinite(a).all() for alphas, _ in results for a in alphas)
    out = {"metric": f"fps_{h}x{w}_{args.streams}streams_wire_joint_s4", "value": round(fps, 3),
           "unit": "frames/sec aggregate", "per_stream_fps": round(fps / args.streams, 3),
           "streams": args.streams, "dtype": args.dtype, "wire": "uint8 H2D per frame",
           "warmup_s": round(warmup_s, 1),
           "device": (torch.cuda.get_device_name(ev.device) if ev.device.type == "cuda"
                      else str(ev.device))}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
