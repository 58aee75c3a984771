"""The traced clip's FLOPs (counts/flops.py over the reference at the
cell's shapes, the reads over their valid slots) over its wall time,
against the chip's peak in the cell's precision (counts/peaks.json)."""


def read(ctx):
    return 100.0 * ctx["flops"] / (ctx["window_s"] * ctx["peak_flops"])
