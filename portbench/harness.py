"""What every run shares: the run's context, the traced window and its
reduction, the process's age and the device's readout."""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import time

import numpy as np
import torch

__all__ = ["Context", "process_age", "traced", "power_limit", "worst"]


def process_age():
    """Seconds since this process started (the kernel's start time), or
    since this module was imported where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


@dataclasses.dataclass
class Context:
    """One run: its inputs, and what the window and the trace found."""

    cell: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    #: per-layer spans: name -> [(start event, end event)], recorded only
    #: in a traced run
    spans: dict = dataclasses.field(default_factory=dict)
    #: counts of the window's work (operations, least seconds, ...)
    work: dict = dataclasses.field(default_factory=dict)
    window_s: float = 0.0
    busy_s: float = 0.0
    breakdown: dict = None

    def event(self):
        """A recorded CUDA event (None off the card)."""
        if self.device.type != "cuda":
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def span(self, name, start, end):
        if self.trace and start is not None:
            self.spans.setdefault(name, []).append((start, end))

    def span_hooks(self, module, name):
        """Forward hooks on ``module`` that record span ``name`` around
        each of its calls (none unless the run is traced); returns the
        handles to remove."""
        if not self.trace:
            return []
        starts = []

        def pre(mod, args):
            starts.append(self.event())

        def post(mod, args, out):
            self.span(name, starts.pop(), self.event())
        return [module.register_forward_pre_hook(pre),
                module.register_forward_hook(post)]

    def span_seconds(self, name):
        """The summed device seconds of span ``name`` (None if none)."""
        pairs = self.spans.get(name)
        if not pairs:
            return None
        return sum(a.elapsed_time(b) for a, b in pairs) / 1e3


def worst(values):
    """The largest of ``values``; infinite if any is not a number."""
    values = [float(v) for v in values]
    return max(values) if all(v == v for v in values) else float("inf")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _reduce(prof, ctx):
    """Busy seconds, the top device operations and the longest idle gaps
    of a profile (its CUDA activities: kernels, copies, sets; and the
    CUDA runtime calls the host made), from the profiler's raw events."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        (dev if e.device_type() == DeviceType.CUDA else host).append(
            (s, s + e.duration_ns(), e.name()))
    merged = _merge([(s, t) for s, t, _ in dev])
    ctx.busy_s = sum(t - s for s, t in merged) / 1e9
    by_name = {}
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((merged[k + 1][0] - merged[k][1], merged[k][1],
                    merged[k + 1][0]) for k in range(len(merged) - 1)),
                  reverse=True)[:10]
    starts = np.array([s for s, _, _ in host], dtype=np.int64)
    ends = np.array([t for _, t, _ in host], dtype=np.int64)
    idle = []
    for length, s, t in gaps:
        mid = (s + t) // 2
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        label = host[min(inside, key=lambda k: ends[k] - starts[k])][2] \
            if len(inside) else "host, no CUDA call"
        idle.append([label, length / 1e9])
    ctx.breakdown = {"device_ops": [[n, v] for n, v in top],
                     "idle_gaps": idle}


@contextlib.contextmanager
def traced(ctx):
    """Profile the block's CUDA activity when the run is traced on the
    card, then reduce it into ``ctx``."""
    if not ctx.trace or ctx.device.type != "cuda":
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield
    _reduce(prof, ctx)


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
