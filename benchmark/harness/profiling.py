"""A traced slice: torch.profiler over a function, read into the numbers
the per-layer metrics and the breakdown use.

  window_s   the slice's wall time (host clock, synchronized at both ends)
  busy_s     the union of the device's kernel and copy intervals in it
  kernel_s   device seconds by kernel name
  gaps       idle seconds by the host operation that overlapped the gap:
             the innermost profiled host op at the gap's midpoint, or
             "(python, no torch op)" where none was running
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Callable, Dict, List, Tuple

import torch

NO_OP = "(python, no torch op)"
TOP = 10


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA") and not getattr(
        e, "is_user_annotation", False)


def traced(fn: Callable, device=None):
    """(fn(), summary) with fn run under the profiler on this process's card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    return out, summarize(prof.events(), window_s)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(events, window_s: float) -> Dict:
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if _is_device(e):
            dev.append((e.name, tr.start, tr.end))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    for name, s, e in dev:
        kernel_s[name] += (e - s) * 1e-6
    busy = _union([(s, e) for _, s, e in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps_s: Dict[str, float] = collections.defaultdict(float)
    host.sort()
    starts = [h[0] for h in host]
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        mid = 0.5 * (s + e)
        i, name = bisect.bisect_right(starts, mid), NO_OP
        # the latest-starting host op still running at mid is the innermost
        for j in range(i - 1, max(i - 4000, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        gaps_s[name] += (e - s) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": window_s, "busy_s": min(busy_s, window_s), "kernel_s": dict(kernel_s),
            "breakdown": {"device_ops": top(kernel_s), "idle_gaps": top(gaps_s)}}


def kernel_seconds(summary: Dict, match: Callable[[str], bool]) -> float:
    return sum(v for k, v in summary["kernel_s"].items() if match(k))
