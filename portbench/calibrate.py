"""The readings that the limits of ``correct`` are set from, on the card at
the cell's own size (never part of a benchmark run)::

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 5]

For each of ``--seeds``, the numbers that a run compares for a sound
program (the lower readings); for each of ``--control-seeds``, the same
numbers for the control, and for a training cell for each fault that can
be read without breaking the program (the upper readings).  One JSON
line a reading.

Each driver says what its readings are (``drivers/<entry>.py``
``readings``): the control and the faults belong to the entry point.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import harness, manifest

__all__ = ["readings", "main"]


def _ctx(cell, cfg, mix, seed, seconds, device):
    return harness.Context(cell=cell, cfg=cfg, mix=mix, seed=seed,
                           seconds=seconds, trace=False,
                           device=torch.device(device))


def readings(cell, seeds, control_seeds, seconds=5.0, device="cuda"):
    """``(kind, seed, numbers)`` of every reading of ``cell``: the
    program on ``seeds`` and ``control_seeds``, the control and the
    faults on ``control_seeds``."""
    bench = manifest.load()
    w = manifest.workload(bench, cell)
    cfg, mix = manifest.config(w["config"]), manifest.mix(w["traffic"])
    drv = manifest.load_module("drivers", mix["entry"])
    seeds = list(seeds) + [s for s in sorted(control_seeds) if s not in seeds]

    def make(seed):
        return _ctx(cell, cfg, mix, seed, seconds, device)
    yield from drv.readings(make, seeds, set(control_seeds))


def main(argv=None):
    p = argparse.ArgumentParser(prog="portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for kind, seed, got in readings(args.workload, seeds, control,
                                    args.seconds):
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
