"""Entry ``nw_train``: the differentiable alignment layer alone, as a
library user trains through it.

A step is ``deepblast_torch.ops.dp.expected_alignment(theta, A)``, the
port's training loss (``train.losses.matrix_cross_entropy``) against the
true paths and their gap mask, and ``backward()`` to ``theta`` and
``A``.  The inputs are the mix's seeded ``potentials`` batch, on the
card.  Set-up runs two steps; the window issues steps back to back and
synchronises once, after the first step issued past ``--seconds``.
``layer_pairs_per_s`` is the pairs of every step over the window.

The configuration's ``alignment`` block, updated by the mix's, sets the
backend, the storage menu (``dtypes``: the library default ``None`` keeps
every stream float32) and the Q storage of the Q backends (``q_dtype``).

What is judged: the last step's loss against the reference's over the
whole batch (relative gap), and its ``E`` and the gradients of ``theta``
and ``A`` on a sample of pairs drawn from the seed (largest gap over the
largest reference value).  The reference differentiates the plain
recursion twice, in float64.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from portbench import traffic
from portbench.count import dp as count
from portbench.harness import worst
from portbench.reference import nw
from portbench.reference import train as ref_train

__all__ = ["setup", "window", "check", "compare", "program_options",
           "readings"]


def program_options(cfg, mix, control=False):
    """``(backend, dtypes, q_dtype)`` of the configuration's ``alignment``
    block, updated by the mix's; ``control`` switches on the program's own
    lower-precision path (bf16 differences for the default backend, bf16
    Q streams for the Q backends)."""
    from deepblast_torch.ops.menu import DTypeMenu
    a = dict(cfg["alignment"], **mix.get("alignment", {}))
    menu, q = a.get("dtypes"), a.get("q_dtype")
    if control:
        if a["backend"] in ("pallas", "pallas_long"):
            q = "bfloat16"
        else:
            menu = dict(menu or {}, d="bfloat16")
    return (a["backend"], DTypeMenu.make(**menu) if menu else None,
            getattr(torch, q) if q else None)


@dataclasses.dataclass
class _State:
    inputs: dict
    options: tuple
    loss_fn: object
    last: dict = None


def _step(ctx, st, record=False):
    from deepblast_torch.ops import dp
    b = st.inputs
    backend, menu, q = st.options
    dp.Q_DTYPE = q
    theta, A = b["theta"], b["A"]
    theta.grad = A.grad = None
    ev = []
    if record:
        ev.append(ctx.event())
    E = dp.expected_alignment(theta, A, (b["x_len"], b["y_len"]), mode="nw",
                              operator=ctx.cfg["alignment"]["operator"],
                              backend=backend, dtypes=menu)
    if record:
        ev.append(ctx.event())
        E.register_hook(lambda g: ev.append(ctx.event()))
        done = []

        def grad_hook(g):
            done.append(1)
            if len(done) == 2:
                ev.append(ctx.event())
        hooks = [theta.register_hook(grad_hook), A.register_hook(grad_hook)]
    loss = st.loss_fn(b["aln"], E, b["x_len"], b["y_len"], b["gmask"])
    loss.backward()
    if record:
        for h in hooks:
            h.remove()
        ctx.span("dp", ev[0], ev[1])
        ctx.span("dp", ev[2], ev[3])
    return E, loss


def setup(ctx, control=False):
    inputs = traffic.potentials(ctx.mix, ctx.seed, ctx.device)
    inputs["theta"].requires_grad_(True)
    inputs["A"].requires_grad_(True)
    from deepblast_torch.train.losses import matrix_cross_entropy
    st = _State(inputs, program_options(ctx.cfg, ctx.mix, control),
                matrix_cross_entropy)
    for _ in range(2):
        _step(ctx, st)
    return st


def window(ctx, st):
    cuda = ctx.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    steps = 0
    while True:
        E = loss = None     # the last step's outputs go before the next's
        E, loss = _step(ctx, st, record=ctx.trace)
        steps += 1
        if time.perf_counter() >= deadline:
            break
    if cuda:
        torch.cuda.synchronize()
    ctx.window_s = time.perf_counter() - t0
    b = st.inputs
    st.last = {"E": E.detach(), "loss": float(loss.detach()),
               "g_theta": b["theta"].grad, "g_A": b["A"].grad}
    cells = count.valid_cells(b["x_len"].tolist(), b["y_len"].tolist())
    ctx.work["dp_least_s"] = steps * count.dp_train_least_s(cells)
    ctx.work["step_least_s"] = steps * (count.dp_train_least_s(cells)
                                        + count.loss_least_s(cells))
    B = b["theta"].shape[0]
    return {"attempted": steps, "failed": 0,
            "metrics": {"layer_pairs_per_s": steps * B / ctx.window_s}}


def _rel(p, r):
    return float((p - r).abs().max()) / max(float(r.abs().max()), 1e-30)


def compare(ctx, st, dp_dtype=torch.float64):
    """The gaps of the last step's outputs from the reference's."""
    b, last = st.inputs, st.last
    B = b["theta"].shape[0]
    blk = ctx.mix["check_block"]
    xl, yl = b["x_len"].long(), b["y_len"].long()
    per_pair = []
    with torch.no_grad():
        for s in range(0, B, blk):
            sl = slice(s, s + blk)
            E = nw.expected(b["theta"][sl].detach().to(dp_dtype),
                            b["A"][sl].detach().to(dp_dtype), xl[sl], yl[sl])
            per_pair.append(ref_train.pair_cross_entropy(
                b["aln"][sl].to(dp_dtype), E, xl[sl], yl[sl], b["gmask"][sl]))
            del E
    ref_loss = float(torch.cat(per_pair).mean())
    picked = traffic.rng(ctx.seed, "sample").permutation(B)[
        :ctx.mix["check_pairs"]].tolist()
    idx = torch.tensor(sorted(picked), device=ctx.device)
    th = b["theta"].detach()[idx].to(dp_dtype).requires_grad_(True)
    A = b["A"].detach()[idx].to(dp_dtype).requires_grad_(True)
    E = nw.expected(th, A, xl[idx], yl[idx], create_graph=True)
    loss = ref_train.pair_cross_entropy(b["aln"][idx].to(dp_dtype), E,
                                        xl[idx], yl[idx], b["gmask"][idx])
    g_th, g_A = torch.autograd.grad(loss.sum() / B, [th, A])
    gaps = {"loss_gap": abs(last["loss"] - ref_loss) / abs(ref_loss),
            "e_gap": float((last["E"][idx].double()
                            - E.detach().double()).abs().max()),
            "grad_gap": worst([_rel(last["g_theta"][idx].double(), g_th.double()),
                               _rel(last["g_A"][idx].double(), g_A.double())])}
    return {k: worst([v]) for k, v in gaps.items()}


def check(ctx, st):
    got = compare(ctx, st)
    return {k: (got[k], lim) for k, lim in ctx.mix["limits"].items()}


def _half_loss(Y, E, xl, yl, G):
    """The program's loss over the first half of the batch (the mean over
    the rest)."""
    from deepblast_torch.train import losses
    k = E.shape[0] // 2
    return losses.matrix_cross_entropy(Y[:k], E[:k], xl[:k], yl[:k], G[:k])


def readings(make, seeds, control_seeds):
    """``(kind, seed, numbers)`` for ``portbench.calibrate``: a short
    window of the program; the control, the program with its own
    lower-precision storage switched on (bf16 differences, or bf16 Q
    streams on the Q backends); the fault ``half``, the program's loss
    over half of the batch."""
    for seed in seeds:
        kinds = [("program", {})]
        if seed in control_seeds:
            kinds += [("control", {"control": True}), ("fault:half", {})]
        for kind, kw in kinds:
            ctx = make(seed)
            st = setup(ctx, **kw)
            if kind == "fault:half":
                st.loss_fn = _half_loss
            window(ctx, st)
            yield kind, seed, compare(ctx, st)
            del st
            torch.cuda.empty_cache()
