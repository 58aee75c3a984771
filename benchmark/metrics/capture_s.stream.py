"""Seconds the evaluator's CUDA graphs spent in their captures during
set-up (models/graphs.py GraphCache.capture_s)."""


def read(ctx):
    return ctx["counters"].get("capture_s")
