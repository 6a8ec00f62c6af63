"""``deepblast-benchmark`` on the card: throughput sweeps of the DP
(``deepblast_tpu/cli/benchmark.py``).

    python -m deepblast_torch.cli.benchmark --device cuda --depth decode \\
        --batch-size 256 --length 512 --dtype-menu d-bf16

The sweeps are the JAX package's: the reference's batch sizes 4-256 at 800
x 800 (``--sweep batch``), lengths 64-1024 at ``--batch-size``
(``--sweep length``), or one shape (``headline``).  Each configuration
prints one JSON line with the JAX record's keys, the storage menu's label
and the card's name (``device``).  The inputs are the JAX ones, drawn by
``np.random.default_rng(0)``: ``theta`` standard normal, ``A`` standard
normal - 1, float32, full lengths.  ``--depth`` picks the function timed:

* ``fwd``: :func:`~deepblast_torch.ops.dp.alignment_score`;
* ``fwd+bwd``: :func:`~deepblast_torch.ops.dp.expected_alignment`;
* ``decode``: :func:`~deepblast_torch.ops.dp.expected_alignment_stream`
  (what ``bench.py`` times); on a backend without a stream layout
  (``pallas``, ``pallas_long``) the expected alignment, which is what
  ``DeepBLAST.align`` decodes with there (the JAX benchmark raises);
* ``train``: ``torch.autograd.grad`` of ``(E * E).sum()`` in ``theta`` and
  ``A``, which runs the two adjoint passes.

``--backend scan`` times the scan backend's plain operations per
anti-diagonal, on the card as on the CPU.  Times are
:func:`~deepblast_torch.utils.timing.time_op`'s: CUDA events
around windows of back-to-back calls.  Without a card it raises unless
``--device cpu`` asks for the plain passes on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

DEPTHS = ("fwd", "fwd+bwd", "decode", "train")


def make_menu(name):
    """Named storage-dtype menus (``ops/menu.py`` ``DTypeMenu``)."""
    if name in (None, "fp32"):
        return None
    from deepblast_torch.ops.menu import DTypeMenu
    return {
        # the --dp-bf16-residuals training config
        "d-bf16": DTypeMenu.make(d="bfloat16"),
        # everything 16-bit (inference and bench only)
        "all-bf16": DTypeMenu.make(stream="bfloat16", d="bfloat16",
                                   e="bfloat16"),
        "i16": DTypeMenu.make(stream="int16", d="bfloat16", e="int16"),
    }[name]


def inputs(B, N, M, device):
    """The JAX benchmark's draw: ``(theta, A, (ln, lm))`` on ``device``."""
    import torch
    rng = np.random.default_rng(0)
    theta = rng.standard_normal((B, N, M)).astype(np.float32)
    A = (rng.standard_normal((B, N, M)) - 1.0).astype(np.float32)
    ln = torch.full((B,), N, dtype=torch.int32, device=device)
    lm = torch.full((B,), M, dtype=torch.int32, device=device)
    return (torch.from_numpy(theta).to(device),
            torch.from_numpy(A).to(device), (ln, lm))


def depth_op(depth, lengths, mode, backend, dtypes):
    """``op(theta, A)``: the function ``depth`` times."""
    import torch

    from deepblast_torch.ops import dp as dp_ops
    kw = dict(mode=mode, backend=backend, dtypes=dtypes)
    if depth == "fwd":
        return lambda theta, A: dp_ops.alignment_score(theta, A, lengths,
                                                       **kw)
    if depth == "fwd+bwd" or (depth == "decode" and
                              not dp_ops.get_backend(backend).stream):
        return lambda theta, A: dp_ops.expected_alignment(theta, A, lengths,
                                                          **kw)
    if depth == "decode":
        return lambda theta, A: dp_ops.expected_alignment_stream(
            theta, A, lengths, **kw)
    if depth == "train":
        def grad(theta, A):
            E = dp_ops.expected_alignment(theta, A, lengths, **kw)
            return torch.autograd.grad((E * E).sum(), (theta, A))
        return grad
    raise ValueError(f"unknown depth {depth!r}; expected one of {DEPTHS}")


def run_config(B, N, M, mode, backend, depth, iters, reps=4, dtypes=None,
               device="cuda"):
    """Time one configuration; returns its record."""
    import torch

    from deepblast_torch.train.trainer import resolve_device
    from deepblast_torch.utils.timing import time_op
    device = resolve_device(device)
    theta, A, lengths = inputs(B, N, M, device)
    if depth == "train":
        theta.requires_grad_()
        A.requires_grad_()
    op = depth_op(depth, lengths, mode, backend, dtypes)
    dt = time_op(op, theta, A, reps=reps, iters=iters)
    return dict(B=B, N=N, M=M, mode=mode, backend=backend, depth=depth,
                seconds=dt, alignments_per_sec=B / dt,
                cell_updates_per_sec=B * N * M / dt,
                device=torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu")


def main(argv=None):
    from deepblast_torch.ops import dp as dp_ops
    parser = argparse.ArgumentParser("deepblast-benchmark")
    parser.add_argument("--sweep", choices=["batch", "length", "headline"],
                        default="headline")
    parser.add_argument("--mode", default="nw", choices=["nw", "sw"])
    parser.add_argument("--backend", default=None,
                        choices=[None, *dp_ops.BACKENDS])
    parser.add_argument("--depth", default="fwd+bwd", choices=DEPTHS)
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--length", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--dtype-menu", default="fp32",
                        choices=["fp32", "d-bf16", "all-bf16", "i16"],
                        help="storage-dtype menu of the default backend's "
                             "kernels (d-bf16 = the --dp-bf16-residuals "
                             "training config)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, or cpu for "
                             "the plain passes)")
    args = parser.parse_args(argv)
    be = dp_ops.get_backend(args.backend)
    dtypes = make_menu(args.dtype_menu)
    menu_label = args.dtype_menu
    if dtypes is not None and not be.takes_menu:
        # label the record honestly when the backend ignores the menu
        print(f"# --dtype-menu {args.dtype_menu} ignored: backend "
              "has no storage-dtype support (fp32)", flush=True)
        dtypes = None
        menu_label = f"{args.dtype_menu} (ignored: fp32 backend)"

    if args.sweep == "batch":
        configs = [(b, 800, 800) for b in (4, 8, 16, 32, 64, 128, 256)]
    elif args.sweep == "length":
        configs = [(args.batch_size, n, n)
                   for n in (64, 128, 256, 512, 1024)]
    else:
        configs = [(args.batch_size, args.length, args.length)]

    for B, N, M in configs:
        res = run_config(B, N, M, args.mode, args.backend, args.depth,
                         args.iters, dtypes=dtypes, device=args.device)
        res["dtype_menu"] = menu_label
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
