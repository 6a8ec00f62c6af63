#!/usr/bin/env python3
"""Data parallel training against one process on one NVIDIA GPU:
``chip_smoke.py``'s kernel build, then its phase ``parallel`` alone
(two gloo ranks sharing the card run ``cli.train`` while one process runs
the same command, an NCCL world of one rank, and the search on the two
ranks), each run logged with its differences whether or not it passes.

    python3 scripts/torch_parallel_check.py [--float32-residuals]

The phase runs at the default storage menu (bf16 residuals); with
``--float32-residuals`` it runs again with ``--no-dp-bf16-residuals``
added to every ``cli.train`` command.  Run it from the root of a
checkout; it needs CUDA.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser("torch_parallel_check")
    parser.add_argument("--float32-residuals", action="store_true")
    args = parser.parse_args(argv)
    card = cs.card_line()
    cs.log(card)
    cs.phase_build()
    menus = [[]] + ([["--no-dp-bf16-residuals"]]
                    if args.float32_residuals else [])
    failed = 0
    for extra in menus:
        cs.PHASE[0] = "parallel"
        t0 = time.time()
        try:
            cs.phase_parallel(0, card, extra)
            cs.log(f"{extra or 'default menu'}: passed in "
                   f"{time.time() - t0:.1f} s [{card}]")
        except AssertionError as e:
            failed += 1
            cs.log(f"{extra or 'default menu'}: failed in "
                   f"{time.time() - t0:.1f} s: {e} [{card}]")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
