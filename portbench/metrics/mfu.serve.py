"""``mfu.serve``: the served pairs' matmul operations on valid residues
(the LM, the heads and the potentials, forward; ``count/model.py``) over
the window at the float32 peak outside the tensor cores."""

from portbench.count.peaks import FP32_FLOPS


def read(ctx):
    flops = ctx.work.get("model_flops")
    if not flops or not ctx.window_s:
        return None
    return 100.0 * flops / (ctx.window_s * FP32_FLOPS)
