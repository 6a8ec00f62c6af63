"""Profiling (``deepblast_tpu/utils/profiling.py``, there backed by
``jax.profiler``): a ``torch.profiler`` trace, and the program's own
spans and counters.

The program opens a span where its work happens (``DeepBLAST.fit`` and
``align``, the heads, the DP op) and counts what it issues.  Recording is
off unless a block turns it on with :func:`recording` (or :func:`trace`,
which records for its block): off, :func:`span` returns one shared no-op
context and :func:`count` returns at once, so the program pays one test
of a module flag a call.  On, each span keeps

* its ``name``, its ``id``, its ``parent``'s id (None at the top) and its
  ``root``'s id (its outermost ancestor's: one per ``align`` request and
  one per ``fit`` dispatch, a step or a chunk of ``steps_per_dispatch``);
* ``start_ns`` and ``end_ns`` from ``time.time_ns()``, the clock of the
  ``torch.profiler`` events (``prof.profiler.kineto_results.events()``
  ``start_ns()``), so a host span and the device's activity line up;
* with ``device=True``, once CUDA is in use, a pair of timing CUDA events
  on the current stream, read only by :func:`drain` (``device_s``);

and enters ``torch.profiler.record_function(name)``, so a trace shows it.
A span opened on a thread with no open span of its own (autograd's
device threads, which run the backward passes on CUDA) takes as parent
the span open on the thread that turned recording on: the ``backward``
span around ``loss.backward()``.

:func:`drain` returns what was recorded, ``{"spans": [...], "counters":
{...}}``, and clears it; a span that ends after recording has stopped is
not kept.  The DP kernels' launches are counted in
``ops.dp_cuda.LAUNCHES`` alone.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "recording", "active", "span", "count", "drain"]

_ON = False
_NOOP = contextlib.nullcontext()
_LOCK = threading.Lock()
_IDS = itertools.count(1)
_depth = 0
_owner = None           # the open spans of the thread that turned it on
_spans = []
_counters = {}


class _Open(threading.local):
    """Each thread's open spans, innermost last."""

    def __init__(self):
        self.spans = []


_OPEN = _Open()


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "events", "_rf", "_stack")

    def __init__(self, name, device):
        self.name = name
        self.events = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)) \
            if device and torch.cuda.is_initialized() else None

    def __enter__(self):
        self._stack = _OPEN.spans
        up = self._stack or _owner or ()
        parent = up[-1] if up else None
        self.id = next(_IDS)
        self.parent = parent.id if parent else None
        self.root = parent.root if parent else self.id
        self.start_ns = time.time_ns()
        self._rf = record_function(self.name)
        self._rf.__enter__()
        if self.events:
            self.events[0].record()
        self._stack.append(self)
        return self

    def __exit__(self, *exc):
        self._stack.pop()
        if self.events:
            self.events[1].record()
        self._rf.__exit__(*exc)
        self.end_ns = time.time_ns()
        if _ON:
            _spans.append(self)
        return False


def span(name, device=False):
    """A context that records span ``name`` while recording is on (a
    shared no-op otherwise); ``device`` also times it on the card."""
    if not _ON:
        return _NOOP
    return _Span(name, device)


def count(name, n=1):
    """Add ``n`` to counter ``name`` while recording is on."""
    if not _ON:
        return
    with _LOCK:
        _counters[name] = _counters.get(name, 0) + n


def active():
    """Whether recording is on: a caller tests it before work that only
    feeds a counter."""
    return _ON


@contextlib.contextmanager
def recording():
    """Record spans and counters within the block (blocks nest); what was
    recorded is kept until :func:`drain`."""
    global _ON, _depth, _owner
    with _LOCK:
        _depth += 1
        if _depth == 1:
            _owner = _OPEN.spans
            _ON = True
    try:
        yield
    finally:
        with _LOCK:
            _depth -= 1
            if _depth == 0:
                _ON = False
                _owner = None


def drain():
    """``{"spans": [...], "counters": {...}}`` recorded since the last
    drain, and clear them.  Each span is a dict of ``name``, ``id``,
    ``parent``, ``root``, ``start_ns``, ``end_ns`` and ``device_s`` (its
    seconds on the card, None for a host span); spans are in the order
    they started.  Waits for the card when a span timed it."""
    global _spans, _counters
    with _LOCK:
        spans, counters = _spans, _counters
        _spans, _counters = [], {}
    if any(s.events for s in spans):
        torch.cuda.synchronize()
    out = []
    for s in sorted(spans, key=lambda s: s.id):
        out.append(dict(name=s.name, id=s.id, parent=s.parent, root=s.root,
                        start_ns=s.start_ns, end_ns=s.end_ns,
                        device_s=s.events[0].elapsed_time(s.events[1]) / 1e3
                        if s.events else None))
    return {"spans": out, "counters": counters}


@contextlib.contextmanager
def trace(logdir):
    """Profile the block over the CPU and, when there is a card, CUDA
    activities, recording the program's spans (:func:`recording`) into the
    trace; yield the ``torch.profiler.profile`` (its ``key_averages()``
    sums the operations, and lists each span under its name: on a card
    also as a device row, which is no device time) and write its Chrome
    trace to ``logdir/trace.json`` (viewable in Perfetto) when the block
    ends.  Unless an outer :func:`recording` block is open, what the block
    recorded is then dropped (:func:`drain`): the trace holds it."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with recording(), profile(activities=activities) as prof:
        yield prof
    if not _ON:
        drain()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
