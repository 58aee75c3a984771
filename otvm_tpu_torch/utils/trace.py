"""Spans and counters of the port's own layers: which part of the port a
frame's or a step's host time belongs to, by name.

    with trace.span("serve.frame", clip=k, frame=i):
        ...
    trace.count("serve.frames")

A span records its name, start and end, the span it ran inside (a stack
per thread) and its ids (clip, frame, step, rank); a counter records its
name and n.  Both record while `enable()` is on or while a torch.profiler
session records (the profiler's own flag), so any profiler run gets them,
`utils/logging.py` `profile_trace`'s Chrome export included.  Under a
profiler each span is also a `record_function("otvm.<name>")` range: the
spans sit on the device trace's clock, and the profiler's host ops and
idle gaps fall inside them by name.  Times are ns on `time.time_ns`'s
clock, the one kineto stamps the profiler's events on.  Off, a span is one
flag check and a shared no-op context; `record_function` is never called.

Records are kept up to MAX_RECORDS; later ones are dropped and counted
(`dropped()`).  `take()` hands this process's records over and clears
them; `absorb(rank, records)` keeps another process's, tagged with its
rank (parallel/dist.py `spawn` brings every rank's records back so).

Span names, by layer: serve.frame ⊃ serve.prepare, serve.upload,
serve.step, serve.readback_wait, serve.outputs, serve.prefetch and the
counter serve.frames (eval/runner.py); graphs.replay, graphs.bank_copy
(models/graphs.py); train.step ⊃ train.upload, train.prepare,
train.replay, train.advance (train/graphs.py) or train.device_step (the
eager step) and the counter train.steps (train/trainer.py); data.wait
(cli/train.py).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch

PREFIX = "otvm."            # the spans' names in the profiler's trace
MAX_RECORDS = 1 << 17       # ~40 MB of records at most

_profiling = torch._C._autograd._profiler_enabled
_on = False
_records: List["Record"] = []
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()        # the records and the dropped count, across threads


class Record(NamedTuple):
    name: str
    kind: str                   # "span" or "count"
    start_ns: int
    end_ns: int                 # a count's: its start
    id: int                     # a span's, unique in its process; 0 for a count
    parent: int                 # the enclosing span's id; 0 at the top
    ids: Dict[str, int]
    n: int = 0                  # a count's n
    rank: Optional[int] = None  # set by absorb: the process that recorded it

    @property
    def ms(self) -> float:
        return 1e-6 * (self.end_ns - self.start_ns)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    """Whether `enable()` is on (a profiler session records spans as well)."""
    return _on


def _stack() -> List[int]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(record: Record) -> None:
    global _dropped
    with _lock:
        if len(_records) < MAX_RECORDS:
            _records.append(record)
        else:
            _dropped += 1


_OFF = contextlib.nullcontext()    # the span when nothing records


class _Span:
    __slots__ = ("name", "ids", "id", "parent", "start", "range")

    def __init__(self, name: str, ids: Dict[str, int]):
        self.name, self.ids = name, ids

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.range = None
        self.start = time.time_ns()
        if _profiling():
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        _keep(Record(self.name, "span", self.start, end, self.id, self.parent, self.ids))
        return False


def span(name: str, **ids):
    """A context manager that records `name` around its block while spans
    record; else the shared no-op."""
    if not (_on or _profiling()):
        return _OFF
    return _Span(name, ids)


def count(name: str, n: int = 1) -> None:
    """Records n of `name` while spans record."""
    if _on or _profiling():
        stack = _stack()
        t = time.time_ns()
        _keep(Record(name, "count", t, t, 0, stack[-1] if stack else 0, {}, n))


def records() -> List[Record]:
    """The records kept, oldest first (a copy)."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Records dropped past MAX_RECORDS since the last reset or take."""
    return _dropped


def totals(recs: Optional[Iterable[Record]] = None) -> Dict[str, Dict[str, float]]:
    """By name: a span's number and total ms ({"n", "ms"}), a counter's
    sum ({"n"}), over `recs` (the records kept by default)."""
    out: Dict[str, Dict[str, float]] = collections.defaultdict(lambda: {"n": 0})
    for r in records() if recs is None else recs:
        if r.kind == "span":
            out[r.name]["n"] += 1
            out[r.name]["ms"] = out[r.name].get("ms", 0.0) + r.ms
        else:
            out[r.name]["n"] += r.n
    return dict(out)


def reset() -> None:
    """Drops every record kept."""
    take()


def take() -> List[Record]:
    """The records kept, which are then cleared."""
    global _dropped
    with _lock:
        out = list(_records)
        _records.clear()
        _dropped = 0
    return out


def absorb(rank: int, recs: Iterable[Record]) -> None:
    """Keeps another process's records, tagged with its rank."""
    for r in recs:
        _keep(r._replace(rank=rank))
