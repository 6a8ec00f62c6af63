"""Profiling helpers (``deepblast_tpu/utils/profiling.py``, there backed
by ``jax.profiler``): a ``torch.profiler`` trace and a host-clock timer."""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

__all__ = ["trace", "timed"]


@contextlib.contextmanager
def trace(logdir):
    """Profile the block over the CPU and, when there is a card, CUDA
    activities; yield the ``torch.profiler.profile`` (its
    ``key_averages()`` sums the operations) and write its Chrome trace to
    ``logdir/trace.json`` (viewable in Perfetto) when the block ends."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def timed(label, sink=print):
    """Report the block's host-clock time to ``sink`` as
    ``"<label>: <ms> ms"``."""
    t0 = time.perf_counter()
    yield
    sink(f"{label}: {(time.perf_counter() - t0) * 1e3:.2f} ms")
