"""Entry ``align``: serving through ``DeepBLAST.align(x, y)``, one client in
a closed loop.

Set-up builds the model from the seed and aligns every pair of the mix
once (every shape the window meets).  The window sends the pairs again,
cycling through them in the seed's order, each request timed on the host
from the call to the returned state string, until the first end of a
cycle after ``--seconds``: every run sends whole cycles, the same
requests whatever order a seed gives them.  ``serve_p95_ms`` is the 95th
percentile of every request's time.

What is judged: a sample of the window's answers drawn from the seed,
with the request of the largest pair in it.  The reference works out each
sampled pair's expected alignment and replays the served path on it: at
each step the best move's value less the value of the move taken (the
greedy traceback takes the best).  ``path_gap`` is the largest over the
sample; a path off the matrix reads infinite.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench import program, traffic, weights
from portbench.count import model as count
from portbench.harness import worst
from portbench.reference import model as ref
from portbench.reference import nw

__all__ = ["setup", "window", "check", "compare", "sample", "readings"]


@dataclasses.dataclass
class _State:
    model: object
    rows: list
    served: list = dataclasses.field(default_factory=list)   # (row, states)


def setup(ctx):
    model, _ = program.build(ctx.cfg, ctx.mix, ctx.seed, ctx.device)
    rows = traffic.pair_rows(ctx.mix, ctx.seed)
    for r in rows:
        model.align(r[5], r[6])
    return _State(model, rows)


def window(ctx, st):
    model, rows = st.model, st.rows
    hooks = ctx.span_hooks(model.lm, "lm")
    times, failed = [], 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    k = 0
    now = t0
    while now < deadline or k % len(rows):
        row = rows[k % len(rows)]
        k += 1
        start = time.perf_counter()
        try:
            out = model.align(row[5], row[6])
        except RuntimeError:
            out, failed = None, failed + 1
        now = time.perf_counter()
        times.append(now - start)
        st.served.append((row, out))
    ctx.window_s = now - t0
    for h in hooks:
        h.remove()
    ctx.work["model_flops"] = sum(
        count.pair_serve(len(r[5]), len(r[6]), ctx.cfg)
        for r, _ in st.served)
    n = len(times)
    return {"attempted": n, "failed": failed,
            "metrics": {"serve_p95_ms": float(np.percentile(times, 95)) * 1e3}}


def sample(ctx, served):
    """Indices of the judged answers: the request of the largest pair and
    ``check_requests - 1`` others drawn from the seed."""
    n = len(served)
    big = max(range(n), key=lambda i: len(served[i][0][5]) * len(served[i][0][6]))
    r = traffic.rng(ctx.seed, "sample")
    rest = [i for i in r.permutation(n) if i != big]
    return [big] + rest[:ctx.mix["check_requests"] - 1]


def compare(ctx, st, precision="float64", dp_dtype=None):
    """``path_gap`` of the sampled answers; with another ``precision`` (a
    control), of the reference's own greedy paths at that precision,
    judged by the reference at float64."""
    picked = sample(ctx, st.served)
    pairs = {}
    for i in picked:
        row = st.served[i][0]
        pairs.setdefault(row[0], row)
    names = list(pairs)
    w = weights.model_weights(ctx.cfg, ctx.seed, ctx.device)
    E = dict(zip(names, ref.expected_alignments(w, ctx.cfg, [pairs[n] for n in names])))
    if precision != "float64" or dp_dtype is not None:
        low = ref.expected_alignments(w, ctx.cfg, [pairs[n] for n in names],
                                      precision, dp_dtype)
        answers = {n: nw.greedy_path(e) for n, e in zip(names, low)}
        paths = [answers[st.served[i][0][0]] for i in picked]
    else:
        paths = [st.served[i][1] for i in picked]
    gaps = [nw.path_gap(E[st.served[i][0][0]], p) if p else float("inf")
            for i, p in zip(picked, paths)]
    return {"path_gap": worst(gaps)}


def check(ctx, st):
    st.model = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    got = compare(ctx, st)
    return {k: (got[k], lim) for k, lim in ctx.mix["limits"].items()}


def readings(make, seeds, control_seeds):
    """``(kind, seed, numbers)`` for ``portbench.calibrate``: a short
    window of the program; the control, the reference's own greedy paths
    from TF32 matmuls (the DP in float64), judged at float64."""
    for seed in seeds:
        ctx = make(seed)
        st = setup(ctx)
        window(ctx, st)
        st.model = None
        torch.cuda.empty_cache()
        yield "program", seed, compare(ctx, st)
        if seed in control_seeds:
            yield "control", seed, compare(ctx, st, "tf32", torch.float64)
