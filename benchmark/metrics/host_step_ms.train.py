"""The traced steps' host ms a step outside the batch's upload, on the
slowest rank: for each rank, the sum of the port's train.step spans, each
less the train.upload spans inside it, over that rank's train.steps
counter (otvm_tpu_torch/utils/trace.py; every rank's records of the traced
slice, gathered by parallel/dist.py spawn).  The largest over the ranks,
as the slowest holds the others at the all-reduce.  Nothing where the
port keeps no such spans."""
import collections


def read(ctx):
    try:
        from otvm_tpu_torch.utils import trace
    except ImportError:
        return None
    records = trace.records()
    steps = {(r.rank, r.id): r for r in records if r.kind == "span" and r.name == "train.step"}
    busy, n = collections.Counter(), collections.Counter()
    for r in steps.values():
        busy[r.rank] += r.end_ns - r.start_ns
    for r in records:
        if r.name == "train.upload" and (r.rank, r.parent) in steps:
            busy[r.rank] -= r.end_ns - r.start_ns
        elif r.kind == "count" and r.name == "train.steps":
            n[r.rank] += r.n
    per_rank = [1e-6 * busy[k] / n[k] for k in busy if n[k] > 0]
    return max(per_rank) if per_rank else None
