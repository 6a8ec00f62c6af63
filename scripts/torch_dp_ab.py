#!/usr/bin/env python3
"""Time the DP kernels of two checkouts in turns on one NVIDIA GPU: the
default backend's at the bench shape (B = 256, N = M = 512, nw, softmax),
and the Q-stream kernels of ``pallas_long`` with its decode at the bench
shape, at 8 x 4096 x 4096 and at a long training batch (2 x 3899 x 3757).

    python3 scripts/torch_dp_ab.py BEFORE_ROOT AFTER_ROOT [--turns 1]
        [--only q]

Each root is a checkout of the port (for example ``git archive`` of a
commit unpacked under ``_archive/``).  One child process per (root, turn)
imports that root's ``deepblast_torch``, builds its kernels into the root's
own ``_build/`` (the first turn only), and times with CUDA events: the
single skew, the pair skew in float32, bf16 and int16, the unskew of a
float32, bf16 and int16 E, the forward, the score-only forward and the
backward in every storage form the main paths run, the adjoint forward in
float32, bf16 residuals and bf16 residuals with a Za stream, the adjoint
backward in float32 and bf16 residuals, the decode (pair skew + forward +
backward) in float32, bf16 residuals and the fast menu, and the
differentiable DP step in float32 and bf16 residuals; then, at each of the
three Q shapes, ``forward_q``, ``backward_q`` (E and E with EA),
``adjoint_forward_q`` (without and with Za), ``adjoint_backward_q``, the
``pallas_long`` expected alignment (skew x 2, forward_q, backward_q,
unskew; the rows say alignments/s too) and the ``pallas_long`` DP step
(that expected alignment and ``backward()`` of ``<E, Z>``: adds
adjoint_forward_q, adjoint_backward_q and their relayouts), with the
cluster size each split kernel's wrapper picked (``--only q``: these
alone).  Each root's ptxas report of its
Q-stream kernel instances (registers, stack, spills; one instance per
operator, strip width and cluster or single CTA) is printed once.  The
roots run in the order BEFORE, AFTER, AFTER, BEFORE (``--turns`` repeats
of that order), so that drift of the card falls on both.  Every child
checks that its kernels' outputs equal the first root's on the same
inputs (bit for bit, but for the sign of a zero) and writes one JSON
object; the parent prints, per timing, the least time of each root over
its turns and their ratio, with the card's name and power limit.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

B, N, M = 256, 512, 512
Q_SHAPES = [(256, 512, 512), (8, 4096, 4096), (2, 3899, 3757)]
# float32 streams each Q kernel reads and writes, counted on the valid
# cells (chip_smoke.phase_bench's bound): the least bytes over the H100's
# 3.35 TB/s
Q_STREAMS = {"forward_q": 5, "backward_q": 4, "backward_q gap": 5,
             "adjoint_forward_q": 7, "adjoint_forward_q za": 8,
             "adjoint_backward_q": 9}


def q_fns(B, N, M, g):
    """The Q-stream kernels, the pallas_long decode and its DP step at (B,
    N, M), nw, softmax, full lengths."""
    import torch
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_cuda
    theta = torch.randn((B, N, M), generator=g, device="cuda")
    A = torch.randn((B, N, M), generator=g, device="cuda") - 1.0
    ln = torch.full((B,), N, dtype=torch.int32, device="cuda")
    lm = torch.full((B,), M, dtype=torch.int32, device="cuda")
    Et = torch.ones((B,), device="cuda")
    kw = dict(mode="nw", operator="softmax")
    th_s, A_s = dp_cuda.skew(theta), dp_cuda.skew(A)
    _, *qs = dp_cuda.forward_q(th_s, A_s, ln, lm, **kw)
    E, _ = dp_cuda.backward_q(*qs, ln, lm, Et, mode="nw")
    zt = dp_cuda.skew(torch.randn((B, N, M), generator=g, device="cuda"))
    za = dp_cuda.skew(torch.randn((B, N, M), generator=g, device="cuda"))
    _, *qds = dp_cuda.adjoint_forward_q(*qs, zt, None, ln, lm, **kw)
    Z = torch.randn((B, N, M), generator=g, device="cuda")
    tag = f"({B}, {N}, {M})"

    def step():
        t = theta.clone().requires_grad_()
        a = A.clone().requires_grad_()
        E = dp_ops.expected_alignment(t, a, (ln, lm), backend="pallas_long",
                                      **kw)
        (E * Z).sum().backward()
        return E.detach(), t.grad, a.grad

    return {
        f"forward_q {tag}": lambda: dp_cuda.forward_q(th_s, A_s, ln, lm,
                                                      **kw),
        f"backward_q {tag}": lambda: dp_cuda.backward_q(*qs, ln, lm, Et,
                                                        mode="nw"),
        f"backward_q gap {tag}": lambda: dp_cuda.backward_q(
            *qs, ln, lm, Et, mode="nw", want_gap=True),
        f"adjoint_forward_q {tag}": lambda: dp_cuda.adjoint_forward_q(
            *qs, zt, None, ln, lm, **kw),
        f"adjoint_forward_q za {tag}": lambda: dp_cuda.adjoint_forward_q(
            *qs, zt, za, ln, lm, **kw),
        f"adjoint_backward_q {tag}": lambda: dp_cuda.adjoint_backward_q(
            *qs, *qds, E, ln, lm, mode="nw"),
        f"decode pallas_long {tag}": lambda: dp_ops.expected_alignment(
            theta, A, (ln, lm), backend="pallas_long", **kw),
        f"dp_step pallas_long {tag}": step,
    }


def ptxas_q(so):
    """The Q-stream kernel instances of a library's ptxas report:
    demangled name -> registers, stack, spill stores and loads."""
    out, cur = {}, None
    with open(f"{so}.ptxas") as f:
        for line in f:
            if "Compiling entry function" in line:
                cur = line.split("'")[1]
            elif cur and "_q_kernel" in cur:
                if "Used" in line and "registers" in line:
                    out.setdefault(cur, {})["regs"] = int(
                        line.split("Used")[1].split()[0])
                elif "bytes stack frame" in line:
                    nums = [int(w) for w in line.split() if w.isdigit()]
                    out.setdefault(cur, {}).update(
                        stack=nums[0], spill_stores=nums[1],
                        spill_loads=nums[2])
    from deepblast_torch.ops import dp_cuda
    tool = shutil.which("c++filt") or os.path.join(
        os.path.dirname(dp_cuda._nvcc()), "cu++filt")
    names = subprocess.run([tool], input="\n".join(out),
                           capture_output=True, text=True).stdout.split("\n")
    # the kernel's name and template arguments, past its return type and
    # namespace
    return {re.search(r"(\w+(<[^()]*>)?)(\(|$)", n.strip()).group(1): v
            for n, v in zip(names, out.values())}


def child(root, out, ref, only):
    sys.path.insert(0, root)
    import torch
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_cuda
    from deepblast_torch.ops.menu import DTypeMenu
    from deepblast_torch.train.losses import matrix_cross_entropy
    so = dp_cuda.build()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    if only == "q":
        return q_child(so, out, ref, g)
    theta = torch.randn((B, N, M), generator=g, device="cuda")
    A = torch.randn((B, N, M), generator=g, device="cuda") - 1.0
    ln = torch.full((B,), N, dtype=torch.int32, device="cuda")
    lm = torch.full((B,), M, dtype=torch.int32, device="cuda")
    Et = torch.ones((B,), device="cuda")
    kw = dict(mode="nw", operator="softmax")
    menus = {"f32": None, "d_bf16": DTypeMenu.make(d="bfloat16"),
             "fast": DTypeMenu.make(d="bfloat16", e="int16"),
             "i16": DTypeMenu.make(stream="int16", e="int16"),
             "i16_d_bf16": DTypeMenu.make(stream="int16", d="bfloat16",
                                          e="int16")}

    def streams(menu):
        m = menu or DTypeMenu.make()
        th, a = dp_cuda.skew_pair(theta, A, m.stream_dtype, m.stream_scale)
        _, dx, dm = dp_cuda.forward(th, a, ln, lm, dtypes=menu, **kw)
        return th, a, dx, dm

    data = {k: streams(m) for k, m in menus.items()}
    zt = dp_cuda.skew(torch.randn((B, N, M), generator=g, device="cuda"))

    def adjoint_inputs(k):
        """E (the training backward's) and Dxd, Dmd of menu k."""
        _, _, dx, dm = data[k]
        E, _ = dp_cuda.backward(dx, dm, ln, lm, Et, dtypes=menus[k], **kw)
        _, dxd, dmd = dp_cuda.adjoint_forward(dx, dm, zt, None, ln, lm,
                                              dtypes=menus[k], **kw)
        return E, dxd, dmd

    adj = {k: adjoint_inputs(k) for k in ("f32", "d_bf16")}
    torch.cuda.empty_cache()
    target = (torch.rand((B, N, M), generator=g, device="cuda")
              < 1.0 / N).float()
    za = dp_cuda.skew(torch.randn((B, N, M), generator=g, device="cuda"))
    # the unskew's inputs: the training E in each stored form
    E = adj["f32"][0]
    E_forms = {"f32": E,
               "bf16": dp_cuda.skew(dp_cuda.unskew(E, N, M), torch.bfloat16),
               "int16": dp_cuda.skew(dp_cuda.unskew(E, N, M), torch.int16,
                                     32767.0)}
    gmask = torch.ones((B, N, M), dtype=torch.bool, device="cuda")
    t_req = theta.clone().requires_grad_()
    a_req = A.clone().requires_grad_()

    def fwd(k, store=True):
        th, a, _, _ = data[k]
        fn = dp_cuda.forward if store else dp_cuda.forward_score
        return lambda: fn(th, a, ln, lm, dtypes=menus[k], **kw)

    def bwd(k, **o):
        _, _, dx, dm = data[k]
        return lambda: dp_cuda.backward(dx, dm, ln, lm, Et, dtypes=menus[k],
                                        **o, **kw)

    def afwd(k, with_za=False):
        _, _, dx, dm = data[k]
        return lambda: dp_cuda.adjoint_forward(
            dx, dm, zt, za if with_za else None, ln, lm, dtypes=menus[k],
            **kw)

    def abwd(k):
        _, _, dx, dm = data[k]
        E, dxd, dmd = adj[k]
        return lambda: dp_cuda.adjoint_backward(dx, dm, dxd, dmd, E, ln, lm,
                                                dtypes=menus[k], **kw)

    def pair(k):
        m = menus[k] or DTypeMenu.make()
        return lambda: dp_cuda.skew_pair(theta, A, m.stream_dtype,
                                         m.stream_scale)

    def decode(k):
        def run():
            th, a, dx, dm = streams(menus[k])
            return dp_cuda.backward(dx, dm, ln, lm, Et, dtypes=menus[k],
                                    decode=True, **kw)
        return run

    def step(k):
        def run():
            aln = dp_ops.expected_alignment(t_req, a_req, (ln, lm),
                                            dtypes=menus[k], **kw)
            matrix_cross_entropy(target, aln, ln, lm, gmask).backward()
        return run

    fns = {
        "skew f32": lambda: dp_cuda.skew(theta),
        "skew_pair f32": pair("f32"),
        "skew_pair bf16": lambda: dp_cuda.skew_pair(theta, A,
                                                    torch.bfloat16),
        "skew_pair int16": pair("i16"),
        "forward f32": fwd("f32"), "forward D bf16": fwd("d_bf16"),
        "forward in int16": fwd("i16"),
        "forward in int16 D bf16": fwd("i16_d_bf16"),
        "forward_score f32": fwd("f32", False),
        "forward_score in int16": fwd("i16", False),
        "backward f32": bwd("f32"), "backward D bf16": bwd("d_bf16"),
        "backward f32 gap": bwd("f32", want_gap=True),
        "backward D bf16 gap": bwd("d_bf16", want_gap=True),
        "backward D bf16 E int16 (fast decode)": bwd("fast", decode=True),
        "unskew f32": lambda: dp_cuda.unskew(E_forms["f32"], N, M),
        "unskew bf16": lambda: dp_cuda.unskew(E_forms["bf16"], N, M),
        "unskew int16": lambda: dp_cuda.unskew(E_forms["int16"], N, M),
        "adjoint_forward f32": afwd("f32"),
        "adjoint_forward D bf16": afwd("d_bf16"),
        "adjoint_forward D bf16 Za": afwd("d_bf16", True),
        "adjoint_backward f32": abwd("f32"),
        "adjoint_backward D bf16": abwd("d_bf16"),
        "decode f32": decode("f32"), "decode d_bf16": decode("d_bf16"),
        "decode fast": decode("fast"),
        "dp_step f32": step("f32"), "dp_step d_bf16": step("d_bf16"),
    }

    # the outputs of every kernel timed, for the check against the first
    # root
    prints = {}
    for k, fn in fns.items():
        if not k.startswith("dp_step"):
            v = fn()
            prints[k] = [fingerprint(t) for t in
                         (v if isinstance(v, tuple) else (v,))
                         if t is not None]
            del v
    ms = {k: cuda_ms(fn, 5 if k.startswith("dp_step") else 20)
          for k, fn in fns.items()}
    del fns, data, adj, E_forms, theta, A, t_req, a_req, target, gmask
    torch.cuda.empty_cache()
    q_child(so, out, ref, g, ms, prints)


def fingerprint(t):
    """A position-weighted sum of the stored bits, a zero's sign dropped:
    equal fingerprints are tensors equal by value but for a collision."""
    import torch
    if t.is_floating_point():
        t = t + 0.0                       # -0.0 + 0.0 = +0.0
    bits = t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32).reshape(-1).long()
    w = torch.arange(bits.numel(), device=bits.device) % 1000003 + 1
    return int((bits * w).sum())


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check(prints, ref, part):
    """The outputs' fingerprints against the first root's (saved under
    ``ref``, one file per part)."""
    path = f"{ref}.{part}"
    if os.path.exists(path):
        with open(path) as f:
            want = json.load(f)
        for k, fp in prints.items():
            if fp != want[k]:
                raise AssertionError(f"{k}: outputs differ from the first "
                                     "root's")
    else:
        with open(path, "w") as f:
            json.dump(prints, f)


def q_child(so, out, ref, g, ms=None, prints=None):
    """The Q part of a child: each Q shape's kernels and decode, checked
    against the first root and timed; writes {"ms", "splits", "ptxas"}."""
    import torch
    from deepblast_torch.ops import dp_cuda
    ms = dict(ms or {})
    if prints:
        check(prints, ref, "default")
    splits = {}
    for shape in Q_SHAPES:
        fns = q_fns(*shape, g)
        qprints = {}
        for k, fn in fns.items():
            v = fn()
            qprints[k] = [fingerprint(t) for t in
                          (v if isinstance(v, tuple) else (v,))
                          if t is not None]
            del v
            splits[k] = {n: dict(v) for n, v in getattr(
                dp_cuda, "SPLITS", {}).items() if v}
        check(qprints, ref, f"q{shape}")
        reps = 2 if shape[1] > 1024 else 10
        for k, fn in fns.items():
            ms[k] = cuda_ms(fn, reps)
        del fns
        torch.cuda.empty_cache()
    with open(out, "w") as f:
        json.dump({"ms": ms, "splits": splits, "ptxas": ptxas_q(so)}, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--only", choices=("q",), default=None,
                    help="time the Q-stream kernels and decode alone")
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        return child(*a.child, a.only)
    import torch
    if not torch.cuda.is_available():
        print("torch_dp_ab: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    roots = {"before": os.path.abspath(a.before),
             "after": os.path.abspath(a.after)}
    times = {"before": [], "after": []}
    with tempfile.TemporaryDirectory(dir=os.getcwd()) as tmp:
        ref = os.path.join(tmp, "ref.json")
        for _ in range(a.turns):
            for side in ("before", "after", "after", "before"):
                out = os.path.join(tmp, "out.json")
                subprocess.run([sys.executable, os.path.abspath(__file__),
                                a.before, a.after, "--child", roots[side],
                                out, ref] + (["--only", a.only] if a.only
                                             else []), check=True)
                with open(out) as f:
                    times[side].append(json.load(f))
    for side in ("before", "after"):
        for k, v in times[side][0]["ptxas"].items():
            print(f"ptxas {side}: {k} {json.dumps(v)}", flush=True)
    rows = {}
    for k in times["before"][0]["ms"]:
        b = min(t["ms"][k] for t in times["before"])
        c = min(t["ms"][k] for t in times["after"])
        rows[k] = dict(before_ms=b, after_ms=c, ratio=c / b,
                       turns_before=[t["ms"][k] for t in times["before"]],
                       turns_after=[t["ms"][k] for t in times["after"]],
                       split_after=times["after"][0]["splits"].get(k))
        shape = "" if "(" in k else f" at ({B}, {N}, {M})"
        kern = k.split(" (")[0]
        if kern in Q_STREAMS:
            dims = [int(x) for x in k.split("(")[1].rstrip(")").split(",")]
            cells = dims[0] * dims[1] * dims[2]
            rows[k]["bound_ms"] = Q_STREAMS[kern] * 4 * cells / 3.35e12 * 1e3
            shape = f", bound {rows[k]['bound_ms']:.4f} ms by bytes"
        rate = ""
        if k.startswith("decode pallas_long"):
            pairs = int(k.split("(")[1].split(",")[0])
            rate = (f" ({pairs / b * 1e3:.2f} -> {pairs / c * 1e3:.2f} "
                    f"alignments/s)")
        print(f"{k}: before {b:.4f} ms, after {c:.4f} ms, x{c / b:.3f}"
              f"{rate}{shape} nw softmax; split {rows[k]['split_after']} "
              f"[{card}]", flush=True)
    print(json.dumps({"card": card, "ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
