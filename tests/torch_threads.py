"""PyTorch's CPU threads for the port's tests under pytest-xdist.

Each xdist worker is a process of its own, and PyTorch's intra-op pool
takes every core in each: with 6 workers on 8 cores, six pools of 8
threads contend, and the port's small CPU operations run several times
slower (a test that takes 3.5 s alone took 94 s in a 6-worker run).
Imported by every ``tests/test_torch_*.py``, this module gives each
worker ``cores // workers`` threads (at least one); a run in one process
keeps PyTorch's default.

It also points ``tensorboard``'s TensorFlow compatibility layer at its own
stub (the ``tensorboard.compat.notf`` marker of its no-TensorFlow build):
``torch.utils.tensorboard`` resolves that layer when it is imported, and
where TensorFlow is installed that imports all of it (~20 s a process)
only to write event files, which the stub writes the same.
"""

import os
import sys
import types

import torch

sys.modules.setdefault("tensorboard.compat.notf",
                       types.ModuleType("tensorboard.compat.notf"))


def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // workers))


share_cores()
