#!/usr/bin/env python3
"""Training step times on one NVIDIA GPU, each run in a window of its own
with nothing else working on the card.  Every step of ``fit`` is timed
between two synchronizations of the card (``DeepBLAST._step`` wrapped),
so a step's time is its own host and device work, not a readback gap.

1. Data parallel: ``chip_smoke.py``'s phase ``parallel`` command
   (``parallel_argv``: ProtT5-XL width cut to 2 of 24 blocks, seeded
   weights, + CNN-1024, batch 8, dropout 0, bf16 residuals) on
   ``ROWS`` rows of 100-300 residues (12 steps), first in one process,
   then in one process at batch 4 (a rank's share), then on two gloo
   ranks sharing the card (4 rows a rank), which then time gloo's
   all-reduce of the trained parameters' count of values alone.  Steps
   10-11 of each single process and of rank 0 are traced
   (``utils.profiling.trace``): device time by operation, copies between
   host and card, the card's busy share.
2. cuDNN's deterministic algorithms: phase ``train``'s command
   (ProtT5-XL, 24 blocks, + CNN-1024, 56 rows, batch 16, 1 epoch, bf16
   residuals) with ``torch.backends.cudnn.deterministic`` on, as
   ``models.exact_cuda_math`` sets it, and off, in turns: on, off, off,
   on.

    python3 scripts/torch_step_times.py [--out chiprun_out/step_times.json]

Run it from the root of a checkout; it needs CUDA.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

#: the data parallel runs' training rows: 12 batches of 8
ROWS = 96
#: the steps traced (0-based), after the timed ones
TRACED = (10, 11)
#: DistributedDataParallel's default bucket (``bucket_cap_mb=25``)
BUCKET_BYTES = 25 * 2**20


class step_timer:
    """Wrap ``DeepBLAST._step``: synchronize the card before and after
    each step and keep its milliseconds; trace the steps ``traced`` into
    ``logdir``; with ``deterministic`` set, put ``cudnn.deterministic`` to
    it before each step (after the model's placement set it)."""

    def __init__(self, traced=(), logdir=None, deterministic=None):
        self.ms, self.traced, self.det = [], traced, deterministic
        self.logdir, self.summary = logdir, None

    def __enter__(self):
        from deepblast_torch.train.trainer import DeepBLAST
        from deepblast_torch.utils import profiling
        orig, timer = DeepBLAST._step, self
        stack = contextlib.ExitStack()
        state = {}

        def timed(model, b, generator):
            if timer.det is not None:
                torch.backends.cudnn.deterministic = timer.det
            i = len(timer.ms)
            if timer.traced and i == timer.traced[0]:
                state["prof"] = stack.enter_context(
                    profiling.trace(timer.logdir))
                state["t0"] = time.perf_counter()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(model, b, generator)
            torch.cuda.synchronize()
            timer.ms.append((time.perf_counter() - t0) * 1e3)
            if timer.traced and i == timer.traced[-1]:
                wall = (time.perf_counter() - state["t0"]) * 1e3
                stack.close()
                timer.summary = summarize(state["prof"], wall,
                                          len(timer.traced))
            return out

        self._restore = lambda: setattr(DeepBLAST, "_step", orig)
        DeepBLAST._step = timed
        return self

    def __exit__(self, *exc):
        self._restore()


def summarize(prof, wall_ms, steps, top=8):
    """A traced window's host and device time a step, the device's busy
    share, its copies between host and card, its top device operations,
    and the host time a step in the collective operations."""
    ka = prof.key_averages()
    # a record_function range (DDP's forward, the optimizer's step, gloo's
    # all_reduce) also shows as a device event of its name: not device time
    ranges = {e.key for e in ka
              if e.device_type == torch.autograd.DeviceType.CPU}
    dev = sorted((e for e in ka
                  if e.device_type == torch.autograd.DeviceType.CUDA and
                  e.key not in ranges),
                 key=lambda e: -e.self_device_time_total)
    device = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    comm = {e.key: round(e.cpu_time_total / 1e3 / steps, 4) for e in ka
            if any(w in e.key.lower() for w in ("all_reduce", "allreduce",
                                                "gloo", "nccl"))}
    copies = sum(e.self_device_time_total for e in dev
                 if "memcpy" in e.key.lower()) / 1e3 / steps
    return dict(
        host_ms=round(wall_ms / steps, 4), device_ms=round(device, 4),
        busy=round(device * steps / wall_ms, 4), comm_host_ms=comm,
        memcpy_device_ms=round(copies, 4),
        top_device=[(e.key[:100], round(e.self_device_time_total / 1e3 /
                                        steps, 4), e.count // steps)
                    for e in dev[:top]])


def stats(ms, skip=()):
    """The median and mean of the steps' ms after the first (its
    warm-up), leaving out the steps ``skip``."""
    kept = [t for i, t in enumerate(ms) if i and i not in skip]
    return dict(median_ms=round(float(np.median(kept)), 4),
                mean_ms=round(float(np.mean(kept)), 4), steps=len(kept))


def rank_main(spec_path, r):
    """One gloo rank: ``cli.train`` with its steps timed (rank 0 traces
    ``TRACED``), then gloo's all-reduce of as many float32 values on the
    card as the trained parameters, in DDP's buckets (``BUCKET_BYTES``),
    timed 5 times after one; the result goes to ``<dir>/rank<r>.json``."""
    import torch.distributed as dist
    from deepblast_torch import native
    from deepblast_torch.ops import dp_cuda
    from deepblast_torch.parallel import mesh as mesh_lib
    torch.set_num_threads(2)
    dp_cuda.build()
    native.build()
    with open(spec_path) as f:
        spec = json.load(f)
    mesh_lib.initialize_distributed(f"file://{spec['store']}", 2, r,
                                    backend="gloo")
    try:
        with step_timer(TRACED if r == 0 else (),
                        os.path.join(spec["dir"], "trace_rank0")) as t:
            run = cs.run_cli_train(spec["argv"], outputs=False)
        res = dict(ms=[round(x, 4) for x in t.ms], seconds=run["seconds"],
                   trace=t.summary, dp=run["model"].mesh.size(0))
        n = sum(p.numel() for p in run["model"].aligner.parameters()
                if p.requires_grad)
        grads = torch.ones(n, device="cuda")
        ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for bucket in grads.split(BUCKET_BYTES // 4):
                dist.all_reduce(bucket)
            torch.cuda.synchronize()
            ms.append(round((time.perf_counter() - t0) * 1e3, 4))
        res["all_reduce"] = dict(values=n, ms=ms[1:])
    finally:
        dist.destroy_process_group()
    with open(os.path.join(spec["dir"], f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    return 0


def data_parallel(tmp, card):
    """Part 1: one process, then two gloo ranks, each window alone."""
    paths, lm = cs.parallel_inputs(tmp, 0, ROWS)

    with step_timer(TRACED, os.path.join(tmp, "trace_alone")) as t:
        run = cs.run_cli_train(cs.parallel_argv(paths, lm,
                                                os.path.join(tmp, "alone")),
                               outputs=False)
    one = dict(ms=[round(x, 4) for x in t.ms], seconds=run["seconds"],
               trace=t.summary, **stats(t.ms, TRACED))
    del run
    torch.cuda.empty_cache()
    # a rank's share of the work, alone: batches of 4
    with step_timer(TRACED, os.path.join(tmp, "trace_half")) as t:
        run = cs.run_cli_train(cs.parallel_argv(
            paths, lm, os.path.join(tmp, "half"), ["--batch-size", "4"]),
            outputs=False)
    half = dict(ms=[round(x, 4) for x in t.ms], seconds=run["seconds"],
                trace=t.summary, **stats(t.ms, TRACED))
    del run
    torch.cuda.empty_cache()

    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as f:
        json.dump(dict(store=os.path.join(tmp, "store"), dir=tmp,
                       argv=cs.parallel_argv(paths, lm,
                                             os.path.join(tmp, "ranks"))), f)
    procs = []
    for r in range(2):
        log_f = open(os.path.join(tmp, f"rank{r}.log"), "w+")
        procs.append((f"rank {r}", subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", spec,
             str(r)], stdout=log_f, stderr=subprocess.STDOUT), log_f))
    cs._relay(procs, timeout=600)
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            res = json.load(f)
        res.update(stats(res["ms"], TRACED if r == 0 else ()))
        ranks.append(res)
    out = {"one process (batch 8)": one, "one process (batch 4)": half,
           "rank 0 (4 of 8)": ranks[0], "rank 1 (4 of 8)": ranks[1]}
    for name, res in out.items():
        cs.log(f"data parallel, {name}: steps {res['ms']} ms; median "
               f"{res['median_ms']} ms, mean {res['mean_ms']} ms of steps "
               f"1-{len(res['ms']) - 1} but the traced; fit "
               f"{res['seconds']:.2f} s [{card}]")
        if res["trace"]:
            cs.log(f"data parallel, {name}: trace of steps {TRACED}: "
                   f"{json.dumps(res['trace'])} [{card}]")
        if "all_reduce" in res:
            cs.log(f"data parallel, {name}: gloo all-reduce of "
                   f"{res['all_reduce']['values']} float32 values on the "
                   f"card in {BUCKET_BYTES} byte buckets: "
                   f"{res['all_reduce']['ms']} ms [{card}]")
    return out


def deterministic_ab(tmp, card):
    """Part 2: phase ``train``'s command, cuDNN deterministic on / off /
    off / on."""
    rows, valid = cs.train_rows(0)
    paths = [os.path.join(tmp, n) for n in ("train.tsv", "valid.tsv")]
    cs._write_tsv(paths[0], rows)
    cs._write_tsv(paths[1], valid)
    out = []
    for k, det in enumerate((True, False, False, True)):
        argv = ["--train-pairs", paths[0], "--valid-pairs", paths[1],
                "-o", os.path.join(tmp, f"train{k}"), "--lm-type", "prot_t5",
                "--batch-size", "16", "--epochs", "1", "--seed", "0"]
        with step_timer(deterministic=det) as t:
            run = cs.run_cli_train(argv, outputs=False)
        res = dict(deterministic=det, ms=[round(x, 4) for x in t.ms],
                   total_ms=round(sum(t.ms[1:]), 4), seconds=run["seconds"])
        del run
        torch.cuda.empty_cache()
        cs.log(f"phase train's command, cudnn.deterministic={det}: steps "
               f"{res['ms']} ms, steps 1-{len(t.ms) - 1} {res['total_ms']} "
               f"ms, fit {res['seconds']:.2f} s [{card}]")
        out.append(res)
    torch.backends.cudnn.deterministic = True
    return out


def main(argv=None):
    parser = argparse.ArgumentParser("torch_step_times")
    parser.add_argument("--out", default="chiprun_out/step_times.json")
    parser.add_argument("--rank", nargs=2, metavar=("SPEC", "R"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank:
        return rank_main(args.rank[0], int(args.rank[1]))
    card = cs.card_line()
    cs.log(card)
    cs.phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        res = dict(card=card, data_parallel=data_parallel(tmp, card))
    with tempfile.TemporaryDirectory() as tmp:
        res["deterministic"] = deterministic_ab(tmp, card)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
