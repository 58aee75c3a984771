"""Share of the traced clip's wall time in which no kernel or copy ran on
the card (torch.profiler)."""


def read(ctx):
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
