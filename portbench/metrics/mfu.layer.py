"""``mfu.layer``: the whole alignment-layer step's share of the chip's
peak: the least time of the DP op and of the loss around it
(``count/dp.py``: bytes over HBM bandwidth, transcendentals over the
special-function rate) for every step of the window, over the window."""


def read(ctx):
    least = ctx.work.get("step_least_s")
    if not least or not ctx.window_s:
        return None
    return 100.0 * least / ctx.window_s
