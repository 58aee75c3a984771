"""One run: the cell found by name, the chips checked, its runner run,
the result line printed."""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

from . import cells

# top-level module names that no run may hold once its window has closed:
# the JAX stack and the JAX package the port was made from (compared whole:
# the port's own name starts with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "otvm_tpu")


def process_start(fallback: float) -> float:
    """This process's start on the wall clock (Linux /proc), else
    `fallback`."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return fallback


def forbidden_modules(names) -> List[str]:
    """The names among `names` whose top-level part is a forbidden one."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def parse(argv):
    ap = argparse.ArgumentParser(description="one run of one cell of BENCHMARK.json")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _finite(x):
    return x if x is None or math.isfinite(x) else None


def compared_block(compared: Dict[str, tuple]) -> Dict[str, dict]:
    """Each compared number beside its limit (a non-finite one as null)."""
    return {k: {"value": _finite(v), "limit": lim} for k, (v, lim) in compared.items()}


def verdict(cell: cells.Cell, stats: Dict[str, float]) -> dict:
    """The check's readings, those the cell's limits name compared to them
    (value, limit), and `correct`: every compared reading finite and within
    its limit, and at least one compared."""
    compared = {k: (stats.get(k), lim) for k, lim in cell.limits.items()}
    ok = bool(compared) and all(v is not None and math.isfinite(v) and v <= lim
                                for v, lim in compared.values())
    return {"stats": stats, "compared": compared, "correct": ok}


def result_line(cell: cells.Cell, out: dict, trace: bool) -> dict:
    if trace:
        metrics = cells.per_layer_values(cell, out["trace"])
    else:
        metrics = {m["name"]: {"value": float(out["end_to_end"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": out["kind"], "count": cell.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": device}
    if trace:
        t = out["trace"]
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = t["breakdown"]
    line["compared"] = compared_block(out["compared"])
    return line


def main(argv, root: str, t_import: float) -> int:
    args = parse(argv)
    t_start = process_start(t_import)
    cell = cells.find_cell(root, args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    out = cells.runner(cell).run(cell, seed=args.seed, seconds=args.seconds,
                                 trace=bool(args.trace), t_start=t_start)
    held = forbidden_modules(sys.modules) + list(out.get("forbidden", []))
    if held:
        print("the run holds JAX or the JAX package: " + ", ".join(sorted(set(held))),
              file=sys.stderr)
        return 3
    line = result_line(cell, out, bool(args.trace))
    for name, value in out["stats"].items():
        if name not in out["compared"]:
            print(f"reading {name}: {value!r} (not compared)", file=sys.stderr)
    for name, (value, lim) in out["compared"].items():
        print(f"compared {name}: {value!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
