"""Rank 0's NCCL kernels (ncclDevKernel_*) in the traced steps, device
time over wall time.  Nothing where no NCCL kernel ran."""


def read(ctx):
    spent = sum(s for name, s in ctx["kernel_s"].items() if name.startswith("ncclDevKernel"))
    return 100.0 * spent / ctx["window_s"] if spent > 0 else None
