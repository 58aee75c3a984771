"""The traced clip's host ms a frame outside the wait on the card: the
sum of the port's serve.frame spans, each less the serve.readback_wait
spans inside it, over its serve.frames counter (otvm_tpu_torch/utils/
trace.py; the records of the traced slice, which a profiler session
records).  Nothing where the port keeps no such spans."""


def read(ctx):
    try:
        from otvm_tpu_torch.utils import trace
    except ImportError:
        return None
    records = trace.records()
    frames = {(r.rank, r.id): r for r in records if r.kind == "span" and r.name == "serve.frame"}
    n = sum(r.n for r in records if r.kind == "count" and r.name == "serve.frames")
    if not frames or n <= 0:
        return None
    busy = sum(r.end_ns - r.start_ns for r in frames.values())
    busy -= sum(r.end_ns - r.start_ns for r in records
                if r.name == "serve.readback_wait" and (r.rank, r.parent) in frames)
    return 1e-6 * busy / n
