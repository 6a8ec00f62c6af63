"""``dp_roofline.layer``: the DP op's least time (``count/dp.py``) over
its device time: CUDA events around ``expected_alignment``, and from a
hook on ``E``'s gradient to the later of the hooks on ``theta``'s and
``A``'s gradients.  The same work whatever implements the op."""


def read(ctx):
    least = ctx.work.get("dp_least_s")
    spent = ctx.span_seconds("dp")
    if not least or not spent:
        return None
    return 100.0 * least / spent
