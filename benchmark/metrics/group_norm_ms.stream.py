"""The traced clip's GroupNorm device ms a frame: the device seconds of the
kernels named group_norm (the port's serving GroupNorm, otvm_tpu_torch/
kernels/group_norm.py) or RowwiseMoments (torch's GroupNorm statistics,
where the port calls nn.GroupNorm), over the clip's serve.frames counter
(otvm_tpu_torch/utils/trace.py).  Nothing where no such kernel ran or the
port counts no frames."""


def read(ctx):
    spent = sum(s for name, s in ctx["kernel_s"].items()
                if "group_norm" in name or "RowwiseMoments" in name)
    if spent <= 0:
        return None
    try:
        from otvm_tpu_torch.utils import trace
    except ImportError:
        return None
    n = sum(r.n for r in trace.records() if r.kind == "count" and r.name == "serve.frames")
    return 1e3 * spent / n if n > 0 else None
