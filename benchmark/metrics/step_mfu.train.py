"""The traced steps' FLOPs (forward and backward of the reference's loss
at the global batch, counts/flops.py) over their wall time, against the
peak of all the cell's chips in its precision (counts/peaks.json)."""


def read(ctx):
    return 100.0 * ctx["flops"] / (ctx["window_s"] * ctx["peak_flops"])
