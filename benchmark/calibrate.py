"""Reads a cell's numbers for setting its limits (PERF.md), on the chip at
the cell's own size, many seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 [--what lower]

`program`: the program as a run serves it (set-up, a window of one clip
or three steps, the check); `lower`: the reference in the program's place
in the precision below the configuration's; `half_batch`, `exchange`
(train cells): the reference fed half of each batch, or rank 0's rows
alone; `newest_slot_dropped`, `replayed_alpha_altered` (stream cells):
the program with a fault that only replayed frames meet (checks/control.py).  One JSON line
a seed, with each slot's reading on the joint stream."""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark.checks import control  # noqa: E402
from benchmark.checks import stream as cs  # noqa: E402
from benchmark.harness import cells  # noqa: E402

FAULTS = {"newest_slot_dropped": control.newest_slot_dropped,
          "replayed_alpha_altered": control.replayed_alpha_altered}
WHAT = ("program", "lower", "half_batch", "exchange", *FAULTS)


def _recorder():
    """Wraps the joint stream's slot_rels so that each slot's reading
    lands in `seen`."""
    seen = {}
    slot_rels = cs.slot_rels

    def rels(*a, **k):
        seen["slots"] = slot_rels(*a, **k)
        return seen["slots"]

    cs.slot_rels = rels
    return seen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="lower", choices=WHAT)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = cells.find_cell(ROOT, args.workload)
    seen = _recorder()
    stream = cell.traffic["runner"] == "stream"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        seen.clear()
        if args.what == "program" or args.what in FAULTS:
            undo = FAULTS[args.what]() if args.what in FAULTS else None
            out = cells.runner(cell).run(cell, seed=seed, seconds=0.0, trace=False,
                                         t_start=t0, device=args.device)
            if undo:
                undo()
            values = dict(out["stats"], correct=out["correct"])
        elif stream:
            values = control.stream_readings(cell, seed, args.device)
        else:
            values = control.train_readings(cell, seed, args.device, args.what)
        print(json.dumps({"workload": cell.name, "what": args.what, "seed": seed,
                          "seconds": time.time() - t0, **values, **seen}), flush=True)


if __name__ == "__main__":
    main()
