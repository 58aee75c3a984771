"""Times the memory read on one CUDA card, by the number of K/V splits.

    python -m otvm_tpu_torch.tools.bench_memory_read [--dtype bfloat16|float32] [--reps 20]

For the stream's 512p read (HW=1024, T=6, 1 and 5 valid slots) and the
1088x1920 read (HW=8160, T=3, 2 valid slots): the device time of the kernel
(and the combine, where it splits) with splits 1, 2, 4, 8 and the
wrapper's own choice, and the host time to enqueue one call of the kernel
wrapper and of the plain version.  Device times: CUDA events around one
call, the card held busy while the host enqueues it, L2 flushed before
each call.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from ..kernels import memory_attn as ma
from .kernel_check import device_ms

SHAPES = [(1024, 6, 5, "512p count 5"), (1024, 6, 1, "512p count 1"),
          (8160, 3, 2, "1088x1920 count 2")]


def host_us(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    dt = getattr(torch, args.dtype)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; {args.dtype}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for hw, t, count, label in SHAPES:
        q = torch.randn(1, hw, 128, generator=gen, device="cuda").to(dt)
        k = torch.randn(1, t, hw, 128, generator=gen, device="cuda").to(dt)
        v = torch.randn(1, t, hw, 512, generator=gen, device="cuda").to(dt)
        mask = torch.arange(t, device="cuda")[None] < count
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        chosen = ma.launch_geometry(1, hw, t, 512, sms=sms)[2]
        cells = []
        for s in (1, 2, 4, 8):
            ms = device_ms(lambda: ma.memory_read_cuda(q, k, v, mask, _splits=s), flush, args.reps)
            cells.append(f"splits {s}: {ms:.4f} ms")
        print(f"{label}: " + "; ".join(cells) + f"; the wrapper picks {chosen}")
        kernel_us = host_us(lambda: ma.memory_read_cuda(q, k, v, mask), 200)
        plain_us = host_us(lambda: ma.memory_read_plain(q, k, v, mask), 50)
        print(f"  host enqueue: kernel wrapper {kernel_us:.1f} us, plain {plain_us:.1f} us")


if __name__ == "__main__":
    main()
