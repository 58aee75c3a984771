"""Times the memory read on one CUDA card, by the number of K/V splits.

    python -m otvm_tpu_torch.tools.bench_memory_read [--dtype bfloat16|float32|both]
        [--reps 20] [--out FILE]

For the stream's 512p read (HW=1024, T=6, 5 and 1 valid slots), the
training shapes (B 4, HW 400, T 1 and 2, no mask) and the 1088x1920 read
(HW=8160, T=3 with 2 valid slots, and T=6 with 5, the trimap stream's
full bank): the device time of one read at splits 1 to
8, each merged both ways the card allows (a split read is one launch:
"s x s" one cluster a tile, merged through distributed shared memory; "s
x 1" no cluster, merged through L2, where the grid fits on the card at
once), and at the wrapper's own choice, with the K/V tiles of the dtype
that the bank makes (the split rule's unit) and the output tiles beside
the card's limits; then the host time to enqueue one call of the kernel
wrapper and of the plain version.  This sweep sets `MIN_TILES_PER_SPLIT`
and the choice between the merges.  Device times: CUDA events around one call, the
card held busy while the host enqueues it, L2 flushed before each call.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from ..kernels import memory_attn as ma
from .kernel_check import device_ms

# b, hw, t, valid slots (None: no mask), label
SHAPES = [(1, 1024, 6, 5, "512p count 5"), (1, 1024, 6, 1, "512p count 1"),
          (4, 400, 1, None, "train T=1"), (4, 400, 2, None, "train T=2"),
          (1, 8160, 3, 2, "1088x1920 count 2"), (1, 8160, 6, 5, "1088x1920 count 5 of 6")]


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
    ap.add_argument("--dtype", choices=("bfloat16", "float32", "both"), default="both")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the numbers to this JSON file")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    for dname in (("bfloat16", "float32") if args.dtype == "both" else (args.dtype,)):
        dt = getattr(torch, dname)
        table = ma.max_active_clusters(dt, 128, 512)
        print(f"{dname}: max active clusters by size {table}")
        for b, hw, t, count, label in SHAPES:
            q = torch.randn(b, hw, 128, generator=gen, device="cuda").to(dt)
            k = torch.randn(b, t, hw, 128, generator=gen, device="cuda").to(dt)
            v = torch.randn(b, t, hw, 512, generator=gen, device="cuda").to(dt)
            mask = None if count is None else torch.arange(t, device="cuda")[None] < count
            q_tiles, cv_tiles, *chosen = ma.launch_geometry(b, hw, t, 512, dt, table)
            chosen = "x".join(map(str, chosen))
            row = dict(dtype=dname, shape=label, tiles=-(-t * hw // ma.tile_positions(dt)),
                       output_tiles=q_tiles * cv_tiles * b, chosen=chosen, ms={})
            tiles = q_tiles * cv_tiles * b
            sweep = [(1, None)] + [(s, c) for s in range(2, 9) for c in (s, 1)
                                   if (c == 1 and tiles * s <= table[1])
                                   or (c > 1 and table[c] >= 1)]
            for s, c in sweep:
                row["ms"][f"{s}x{c or 1}"] = device_ms(
                    lambda: ma.memory_read_cuda(q, k, v, mask, _splits=s, _cluster=c), flush,
                    args.reps)
            row["chosen_ms"] = device_ms(lambda: ma.memory_read_cuda(q, k, v, mask), flush,
                                         args.reps)
            row["host_us"] = host_us(lambda: ma.memory_read_cuda(q, k, v, mask), 200)
            row["plain_host_us"] = host_us(lambda: ma.memory_read_plain(q, k, v, mask), 50)
            rows.append(row)
            print(f"{dname} {label}: {row['tiles']} K/V tiles, {row['output_tiles']} output "
                  "tiles; " + "; ".join(f"{s}: {ms:.5f} ms" for s, ms in row["ms"].items())
                  + f"; the wrapper picks {chosen}: {row['chosen_ms']:.5f} ms")
            print(f"  host enqueue: kernel wrapper {row['host_us']:.1f} us, plain "
                  f"{row['plain_host_us']:.1f} us")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
