"""``lm_share.serve``: the device time between CUDA events recorded by
forward hooks around the language model (``models/lm.py``), as a share
of the window."""


def read(ctx):
    s = ctx.span_seconds("lm")
    if s is None or not ctx.window_s:
        return None
    return 100.0 * s / ctx.window_s
