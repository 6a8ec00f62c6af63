"""Entry ``fit``: training through ``DeepBLAST.fit`` on TM-align-like rows.

Set-up builds the model from the seed and runs one epoch of the mix's
rows through ``fit``: every batch shape of the window is met once.  It
then puts the seed's weights back and clears what ``fit`` would resume
from (the optimizer's state and the step count), so that the window
starts from the seeded model with a fresh AdamW, as set-up did, and its
first steps are the ones the reference follows.  The window trains with
``fit`` over the same rows, epoch after epoch, closed loop, until the
first epoch boundary after ``--seconds`` (the dataset refuses the next
epoch's first batch), so that every run does whole epochs: the same
batches, whatever order a seed gives them.  ``train_pairs_per_s`` is the
pairs of every step issued in the window over the window, which ends
once the card has finished them.

What is judged (the mix's ``limits`` name the numbers compared): the
loss of the first step, relative to the reference's, and the change of
the weights after three steps, both of the window's first steps, leaf
by leaf as the gap between the
program's norm and the reference's over the larger of the reference's
norm of that leaf and of the median leaf, the median leaf counting; the
reference runs the same three steps on the same rows from the same
weights in float64.  A leaf whose reference gradient is under a
thousandth of the median leaf's moves by round-off alone and is left out
of the change.  ``gaps`` also reads the first gradient as AdamW got it
(its first moment after one step over ``1 - beta1``), by the worst leaf,
for the records.  The later steps' losses, the worst leaf's change and
the first gradient are not compared: with seeded weights the potentials
reach a few hundred, a third of the true path's cells hold an expected
alignment under 1e-6, and the loss's clamp at 3e-8 has no gradient below
it and one of 3e7 above it, so which side float32 rounds a cell to sets
the first gradient (0.001-0.65 of the reference's by the worst leaf over
eleven seeds); AdamW's ``lr * sign(g)`` first update then carries that
into the later steps of any float32 computation, the reference's own
among them.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from portbench import program, traffic, weights
from portbench.harness import worst
from portbench.count import model as count
from portbench.reference import model as ref

__all__ = ["setup", "window", "check", "check_steps", "program_outputs",
           "reference_outputs", "gaps", "readings", "CHECK_STEPS"]

#: steps the reference follows
CHECK_STEPS = 3


class _Closed(Exception):
    """The window is over: the dataset gives no further batch."""


def _feed(rows, batch_size, max_len):
    """The program's ``TMAlignDataset`` over ``rows``, counting the items
    it gives: ``on_batch(k)`` runs before the first item of batch ``k``,
    and past ``deadline`` the first item of an epoch raises
    :class:`_Closed`."""
    from deepblast_torch.data.dataset import TMAlignDataset

    class Feed(TMAlignDataset):
        def __getitem__(self, i):
            if self.calls % len(self) == 0 and self.deadline is not None \
                    and time.perf_counter() >= self.deadline:
                raise _Closed
            if self.calls % batch_size == 0 and self.on_batch is not None:
                self.on_batch(self.calls // batch_size)
            self.calls += 1
            self.order.append(i)
            return super().__getitem__(i)

    feed = Feed(rows, max_len=max_len)
    if len(feed) != len(rows):
        raise ValueError("the mix has rows that TMAlignDataset drops")
    feed.calls, feed.order, feed.deadline, feed.on_batch = 0, [], None, None
    return feed


class _Losses:
    """A logger of ``fit``'s ``train_loss`` records."""

    def __init__(self):
        self.values = {}

    def log_scalar(self, name, value, step):
        if name == "train_loss":
            self.values[step] = float(value)


@dataclasses.dataclass
class _State:
    model: object
    p0: dict
    rows: list
    feed: object
    losses: _Losses
    names: list
    g1: dict = None
    p3: dict = None


def _snapshot(st, beta1):
    """Batch hook: after step 1 the first gradient from AdamW's first
    moment, after step ``CHECK_STEPS`` the trained weights."""
    def on_batch(k):
        if k == 1:
            opt = st.model.train_state()["optimizer"]["state"]
            if all("exp_avg" in opt.get(i, {}) for i in range(len(st.names))):
                st.g1 = {n: opt[i]["exp_avg"].detach().double() / (1 - beta1)
                         for i, n in enumerate(st.names)}
        elif k == CHECK_STEPS:
            params = dict(st.model.aligner.named_parameters())
            st.p3 = {n: params[n].detach().double().clone()
                     for n in st.names}
    return on_batch


def setup(ctx):
    """Build the model, run one epoch through ``fit``, and put the model
    back as it was built."""
    model, p0 = program.build(ctx.cfg, ctx.mix, ctx.seed, ctx.device)
    rows = traffic.pair_rows(ctx.mix, ctx.seed)
    feed = _feed(rows, ctx.mix["batch_size"], ctx.cfg["training"]["max_len"])
    model.fit(feed, logger=_Losses())
    with torch.no_grad():
        params = dict(model.aligner.named_parameters())
        for n, v in p0.items():
            params[n].copy_(v)
    model.state, model.step = None, 0
    feed.calls, feed.order = 0, []
    return _State(model, p0, rows, feed, _Losses(), list(p0))


def window(ctx, st, steps=None):
    """Train until the first epoch boundary after ``--seconds`` (or, with
    ``steps``, stop before the batch after them)."""
    model, feed, bs = st.model, st.feed, ctx.mix["batch_size"]
    model.config.epochs = 10 ** 9
    snap = _snapshot(st, ctx.cfg["training"]["betas"][0])

    def on_batch(k):
        snap(k)
        if k == steps:
            raise _Closed
    feed.on_batch = on_batch
    hooks = ctx.span_hooks(model.lm, "lm")
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    feed.deadline = t0 + ctx.seconds
    try:
        model.fit(feed, logger=st.losses)
    except _Closed:
        pass
    if cuda:
        torch.cuda.synchronize()
    ctx.window_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    feed.on_batch = feed.deadline = None
    done = model.step
    served = feed.order[:done * bs]
    ctx.work["model_flops"] = sum(
        count.pair_train(len(st.rows[i][5]), len(st.rows[i][6]), ctx.cfg)
        for i in served)
    return {"attempted": done, "failed": 0,
            "metrics": {"train_pairs_per_s": done * bs / ctx.window_s}}


def _leaf_gaps(prog, refr, names):
    """Each leaf's gap of norms, over the larger of the leaf's and the
    median leaf's reference norm."""
    norms = {n: float(refr[n].norm()) for n in names}
    med = statistics.median(norms.values())
    return [abs(float(prog[n].norm()) - norms[n]) / max(norms[n], med)
            for n in names]


def check_steps(st, batch_size):
    """The rows of the first ``CHECK_STEPS`` steps, in the program's
    order."""
    order = st.feed.order
    return [[st.rows[i] for i in order[k * batch_size:(k + 1) * batch_size]]
            for k in range(CHECK_STEPS)]


def program_outputs(st):
    """``(losses, first gradient, weights after CHECK_STEPS)`` of the
    program (``None`` where a snapshot is missing)."""
    losses = [st.losses.values.get(k + 1, float("nan"))
              for k in range(CHECK_STEPS)]
    return losses, st.g1, st.p3


def reference_outputs(ctx, steps, precision="float64", dp_dtype=None):
    """The same three of the reference on ``steps`` (a list of row
    lists), from the seed's weights."""
    w = weights.model_weights(ctx.cfg, ctx.seed, ctx.device)
    return ref.train_steps(w, ctx.cfg, steps, precision, dp_dtype)


def gaps(st, got, want):
    """The numbers compared: ``loss_gap`` (the first step's loss, relative),
    ``grad_gap`` (the worst leaf's gap of first-gradient norms) and
    ``change_gap`` (the median leaf's gap of change norms)."""
    names = st.names
    loss_gap = worst([abs(got[0][0] - want[0][0]) / abs(want[0][0])])
    if got[1] is None or got[2] is None:
        return {"loss_gap": loss_gap, "grad_gap": float("inf"),
                "change_gap": float("inf")}
    gn = {n: float(want[1][n].norm()) for n in names}
    floor = 1e-3 * statistics.median(gn.values())
    moved = [n for n in names if gn[n] >= floor]
    p0 = {n: st.p0[n].double() for n in names}
    d_got = {n: got[2][n].to(p0[n].device) - p0[n] for n in moved}
    d_want = {n: want[2][n].to(p0[n].device) - p0[n] for n in moved}
    change = _leaf_gaps(d_got, d_want, moved)
    return {"loss_gap": loss_gap,
            "grad_gap": worst(_leaf_gaps(got[1], want[1], names)),
            "change_gap": statistics.median(change)
            if all(c == c for c in change) else float("inf")}


def _release(st):
    st.model = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(ctx, st):
    _release(st)
    want = reference_outputs(ctx, check_steps(st, ctx.mix["batch_size"]))
    got = gaps(st, program_outputs(st), want)
    limits = ctx.mix["limits"]
    return {k: (got[k], limits[k]) for k in limits}


def readings(make, seeds, control_seeds):
    """``(kind, seed, numbers)`` for ``portbench.calibrate``: the program's
    first ``CHECK_STEPS`` steps of the window after a whole set-up (the
    reference follows only those); the control, the reference in the
    program's place with its matmuls in TF32 (the DP has none and stays
    float64); the fault ``half``, the reference over half of each batch.
    A state left unchanged reads 1 by the measure's definition."""
    for seed in seeds:
        ctx = make(seed)
        bs = ctx.mix["batch_size"]
        st = setup(ctx)
        window(ctx, st, steps=CHECK_STEPS + 1)
        _release(st)
        steps = check_steps(st, bs)
        want = reference_outputs(ctx, steps)
        yield "program", seed, gaps(st, program_outputs(st), want)
        if seed in control_seeds:
            yield "control", seed, gaps(
                st, reference_outputs(ctx, steps, "tf32", torch.float64),
                want)
            half = [rows[:bs // 2] for rows in steps]
            yield "fault:half", seed, gaps(
                st, reference_outputs(ctx, half), want)
