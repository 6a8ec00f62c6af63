"""``device_idle.serve``: the share of the window in which the card ran
no kernel, copy or set (the union of the profiler's CUDA activity
intervals, ``harness._reduce``)."""


def read(ctx):
    if not ctx.window_s or not ctx.busy_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
