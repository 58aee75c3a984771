"""Streaming joint (stage-4) inference throughput: the port of the JAX
package's bench.py.

    python -m otvm_tpu_torch.bench [--device cuda|cpu] [--eager]

bench.py's environment variables, with its defaults:
  BENCH_RES 512x512     frame size
  BENCH_BATCH 1         streams in one bank (B)
  BENCH_CHUNK 1         frames a call (eval_chunk_step), memorize flags from
                        the global frame index
  BENCH_FRAMES 60       timed frames
  BENCH_DTYPE bf16      bf16 or fp32 (TF32 off)
  BENCH_WIRE 0          1: every frame goes up as uint8 inside the timed loop
  BENCH_WIRE_OUT 0      1: also the uint8 alpha and label come back every
                        frame, pipelined one frame deep (implies BENCH_WIRE)
and bench.py's protocol: the full-width stage-4 models with random weights
from seed 0 (`init_models`), a bank of at most 5, memorize every 10th
frame, 3 warm-up frames, 4 seeded frames cycled, the nested-box first
trimap.  On CUDA each frame's step replays its CUDA graph
(models/graphs.py); --eager runs it eagerly.  JAX compiles one step for
every flag before it times; the graphs are one a (count, memorize, last),
so an untimed pass of the timed frames comes first, on a copy of the
bank, on either path.

Prints one JSON line with bench.py's keys and metric names:
{"metric": "fps_512p_joint_s4" (512x512, B 1, chunk 1; else
"fps_{H}x{W}_b{B}_c{C}_joint_s4"), plus "_wire" or "_wireio", "value":
frames/s (all streams), "unit": "frames/sec", "vs_baseline": value / 30,
"device": the card's name ("cpu" for a CPU run, which checks the protocol
and measures no device)}.  The captures go to standard error.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .eval.runner import _Device
from .models.graphs import FrameStepGraphs
from .models.memory import MemoryBank
from .models.otvm import eval_chunk_step, eval_frame_step, make_eval_bank, serving_models

N_WARMUP = 3
MAX_MEM = 5
SKIP = 10
BASELINE_FPS = 30.0


@dataclasses.dataclass(frozen=True)
class Settings:
    height: int = 512
    width: int = 512
    batch: int = 1
    chunk: int = 1
    frames: int = 60
    dtype: str = "bf16"
    wire: bool = False
    wire_out: bool = False

    @classmethod
    def from_env(cls, env: Mapping[str, str] = os.environ) -> "Settings":
        h, w = (int(x) for x in env.get("BENCH_RES", "512x512").split("x"))
        wire_out = env.get("BENCH_WIRE_OUT", "0") == "1"
        return cls(h, w, int(env.get("BENCH_BATCH", "1")), int(env.get("BENCH_CHUNK", "1")),
                   int(env.get("BENCH_FRAMES", "60")), env.get("BENCH_DTYPE", "bf16"),
                   env.get("BENCH_WIRE", "0") == "1" or wire_out, wire_out)

    @property
    def metric(self) -> str:
        """bench.py:147-153's name for these settings."""
        name = ("fps_512p_joint_s4"
                if (self.height, self.width, self.batch, self.chunk) == (512, 512, 1, 1)
                else f"fps_{self.height}x{self.width}_b{self.batch}_c{self.chunk}_joint_s4")
        return name + ("_wireio" if self.wire_out else "_wire" if self.wire else "")


def _nested_box(b: int, h: int, w: int) -> np.ndarray:
    tri = np.zeros((b, h, w, 3), np.float32)              # bench.py:75-81
    tri[..., 0] = 1.0
    tri[:, h // 4:-h // 4, w // 4:-w // 4] = (0, 1, 0)
    tri[:, 3 * h // 8:-3 * h // 8, 3 * w // 8:-3 * w // 8] = (0, 0, 1)
    return tri


def _copy(bank: MemoryBank) -> MemoryBank:
    return MemoryBank(bank.keys.clone(), bank.values.clone(), bank.count)


def _restore(bank: MemoryBank, saved: MemoryBank) -> MemoryBank:
    bank.keys.copy_(saved.keys)
    bank.values.copy_(saved.values)
    return MemoryBank(bank.keys, bank.values, saved.count)


def run(s: Settings, stm, fba, graphs: Optional[FrameStepGraphs] = None) -> float:
    """bench.py's timed loop on the served (stm, fba): frames/s over all
    streams.  graphs: the step's CUDA graphs of (stm, fba); None: eager."""
    device, dtype = next(fba.parameters()).device, next(fba.parameters()).dtype
    b, h, w, n = s.batch, s.height, s.width, s.frames
    step = graphs or functools.partial(eval_frame_step, stm, fba)
    bank = (graphs.bank(b, h, w, MAX_MEM, dtype) if graphs is not None else
            make_eval_bank(b, h, w, MAX_MEM, dtype, stm.scale, device=device))
    io = _Device()
    io.device = device
    rng = np.random.RandomState(0)
    if s.wire:
        frames_u8 = [(rng.rand(b, h, w, 3) * 255).astype(np.uint8) for _ in range(4)]
        frames = [torch.from_numpy(f).to(device) for f in frames_u8]   # warm-up only
    else:
        frames = [torch.from_numpy(rng.rand(b, h, w, 3)).to(device, dtype) for _ in range(4)]
    first_tri = torch.from_numpy(_nested_box(b, h, w)).to(device, dtype)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    out = step(bank, frames[0], first_tri, True, False, False, MAX_MEM, wire_u8_out=s.wire_out)
    for i in range(1, N_WARMUP):
        out = step(out.bank, frames[i % 4], first_tri, False, i % SKIP == 0, False, MAX_MEM,
                   wire_u8_out=s.wire_out)
    sync()
    if not bool(out.alpha.float().isfinite().all()):
        raise RuntimeError("non-finite alpha")
    bank = out.bank

    if s.chunk > 1:
        c = s.chunk
        chunk_frames = torch.stack([frames[i % 4] for i in range(c)])
        false = [False] * c
        # memorize flags from the GLOBAL frame index, as bench.py:104-109
        mem_flags = lambda start: [(start + i) % SKIP == 0 for i in range(c)]
        chunk = lambda bank, start: eval_chunk_step(stm, fba, bank, chunk_frames, first_tri, false,
                                                    mem_flags(start), false, MAX_MEM,
                                                    graphs=graphs)[0]
        bank = chunk(bank, 0)
        n_chunks = max(n // c, 1)

        def timed(bank):
            for k in range(n_chunks):
                bank = chunk(bank, k * c)
            sync()
            return bank
        frames_done = n_chunks * c * b
    else:
        def frame(i):
            if not s.wire:
                return frames[i % 4]
            into = None if graphs is None else graphs.frame_buffer((b, h, w, 3), torch.uint8)
            return io._upload(frames_u8[i % 4], into)

        def timed(bank):
            pending = None
            for i in range(n):
                out = step(bank, frame(i), first_tri, False, i % SKIP == 0, False, MAX_MEM,
                           wire_u8_out=s.wire_out)
                bank = out.bank
                if s.wire_out:
                    # bench.py:126-141: this frame's copy starts now, the
                    # previous frame's outputs are read
                    started = io._prefetch((out.alpha, out.trimap))
                    if pending is not None:
                        io._fetch(pending)
                    pending = started
            if pending is not None:
                io._fetch(pending)
            sync()
            return bank
        frames_done = n * b

    saved = _copy(bank)
    timed(bank)                                     # untimed: every key of the loop met
    bank = _restore(bank, saved)
    sync()
    t0 = time.perf_counter()
    timed(bank)
    return frames_done / (time.perf_counter() - t0)


def main(argv: Optional[Sequence[str]] = None, models=None) -> dict:
    """Runs the bench, prints its line and returns it.  models: served
    (stm, fba) to time instead of bench.py's full-width ones (tests)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu checks the protocol on the CPU)")
    ap.add_argument("--eager", action="store_true",
                    help="run each frame's step eagerly instead of replaying its CUDA graph")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    s = Settings.from_env()
    dtype = torch.bfloat16 if s.dtype == "bf16" else torch.float32
    # bench.py's models: stage 4, random weights from seed 0, in the serving dtype
    stm, fba = models if models is not None else serving_models(device, dtype)
    graphs = (FrameStepGraphs(stm, fba) if device.type == "cuda" and not args.eager
              else None)
    fps = run(s, stm, fba, graphs)
    line = {"metric": s.metric, "value": round(fps, 3), "unit": "frames/sec",
            "vs_baseline": round(fps / BASELINE_FPS, 4),
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if graphs is not None:
        print(f"graphs: {graphs.captures} captured in {graphs.capture_s:.2f} s, "
              f"{graphs.graphs_per_bucket()} a bucket", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
