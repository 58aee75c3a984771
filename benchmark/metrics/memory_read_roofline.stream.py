"""The traced clip's memory reads: the sum of their least times
(counts/read.py: the larger of operations over the peak and bytes over
the bandwidth, the valid slots only) over the read kernels' device time
(the profiler's kernels named memory_read*).  Nothing when no read kernel
ran."""


def read(ctx):
    spent = sum(s for name, s in ctx["kernel_s"].items() if "memory_read" in name)
    return 100.0 * ctx["read_least_s"] / spent if spent > 0 else None
