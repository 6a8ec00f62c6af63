"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout::

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's traffic mix names the driver of the program's entry point
(``drivers/<entry>.py``), which builds the program from the cell's
configuration and the seed, warms it up on the shapes its traffic uses,
drives it for ``--seconds`` and then judges what the window produced
against the plain reference (``reference/``).  The last line of standard
output is the result; the last lines of standard error are the numbers
compared, each beside its limit.  Without a CUDA card, or with fewer
cards than the cell asks for, it prints no result and exits with 2.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from portbench import harness, manifest

__all__ = ["FORBIDDEN", "run_cell", "main"]

#: top-level module names a run may not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "deepblast_tpu")


#: what the result line shows for a compared number that is not finite
_NOT_A_NUMBER = 1e308


def _finite(v):
    return isinstance(v, (int, float)) and math.isfinite(v)


def run_cell(cell, seed, seconds, trace, device, bench=None, cfg=None,
             mix=None, driver=None):
    """One run of ``cell``; returns the result dict.  ``cfg``, ``mix`` and
    ``driver`` replace the files the manifest names (the CPU tests run
    tiny sizes and broken paths through the rest of a run this way)."""
    bench = bench or manifest.load()
    w = manifest.workload(bench, cell)
    cfg = cfg or manifest.config(w["config"])
    mix = mix or manifest.mix(w["traffic"])
    driver = driver or manifest.load_module("drivers", mix["entry"])
    ctx = harness.Context(cell=cell, cfg=cfg, mix=mix, seed=seed,
                          seconds=seconds, trace=bool(trace),
                          device=torch.device(device))
    cuda = ctx.device.type == "cuda"
    state = driver.setup(ctx)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = harness.process_age()
    with harness.traced(ctx):
        out = driver.window(ctx, state)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {}
    if trace:
        for m in manifest.per_layer(bench, cell):
            v = manifest.load_module("metrics", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        for m in manifest.end_to_end(bench, cell):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    checks = driver.check(ctx, state)
    correct = all(_finite(v) and v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda
                         else "cpu",
                         "count": w["chips"], "memory_peak_bytes": peak}}
    if trace:
        result["device"].update(busy_s=ctx.busy_s, window_s=ctx.window_s)
        if ctx.breakdown:
            result["breakdown"] = ctx.breakdown
    result["checks"] = {k: {"value": v if _finite(v) else _NOT_A_NUMBER,
                            "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv=None):
    p = argparse.ArgumentParser(prog="portbench", description=__doc__.split(
        "\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = manifest.load()
    chips = manifest.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace,
                      "cuda", bench=bench)
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
