"""Reductions of the program's recorded spans (``deepblast_torch.utils.
profiling.drain()``: dicts of ``name``, ``id``, ``parent``, ``root``,
``start_ns``, ``end_ns`` and ``device_s``) for per-layer metrics: a span
name's device seconds and self time, and the card's idle time put down to
the innermost span the host was in.  Pure functions of the spans and of
merged busy intervals on the same clock (``time.time_ns()``, the
profiler's); nothing reads them yet."""

from __future__ import annotations

import numpy as np

__all__ = ["device_seconds", "self_seconds", "idle_by_span", "innermost"]


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


def device_seconds(spans, name):
    """Summed device seconds of the spans ``name`` (None if none has one)."""
    got = [s["device_s"] for s in _named(spans, name)
           if s["device_s"] is not None]
    return sum(got) if got else None


def self_seconds(spans, name):
    """Summed device seconds of the spans ``name`` less those of their
    direct children (None if none has one)."""
    kids = {}
    for s in spans:
        if s["device_s"] is not None and s["parent"] is not None:
            kids[s["parent"]] = kids.get(s["parent"], 0.0) + s["device_s"]
    got = [s["device_s"] - kids.get(s["id"], 0.0) for s in _named(spans, name)
           if s["device_s"] is not None]
    return sum(got) if got else None


def _busy_before(busy, t):
    """Busy nanoseconds before each time of ``t`` (merged, sorted
    ``busy`` intervals, shape (n, 2))."""
    t = np.asarray(t, np.int64)
    if len(busy) == 0:
        return np.zeros_like(t)
    starts, ends = busy[:, 0], busy[:, 1]
    cum = np.concatenate([[0], np.cumsum(ends - starts)])
    k = np.searchsorted(starts, t, side="right")
    last = np.maximum(k - 1, 0)
    part = np.clip(t - starts[last], 0, ends[last] - starts[last])
    return np.where(k > 0, cum[last] + part, 0)


def _idle_within(busy, a, b):
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    return (b - a) - (_busy_before(busy, b) - _busy_before(busy, a))


def idle_by_span(spans, busy, lo, hi):
    """Idle nanoseconds of ``[lo, hi]`` by the innermost span open then
    (key None: no span), from the spans' host stamps and the card's merged
    busy intervals ``busy``; a span's children are nested in it."""
    busy = np.asarray(busy, np.int64).reshape(-1, 2)
    a = np.clip([s["start_ns"] for s in spans], lo, hi)
    b = np.clip([s["end_ns"] for s in spans], lo, hi)
    idle = _idle_within(busy, a, b) if len(spans) else []
    own = {s["id"]: int(v) for s, v in zip(spans, idle)}
    for s, v in zip(spans, idle):
        if s["parent"] in own:
            own[s["parent"]] -= int(v)
    out = {}
    for s in spans:
        out[s["name"]] = out.get(s["name"], 0) + own[s["id"]]
    tops = sum(int(v) for s, v in zip(spans, idle) if s["parent"] not in own)
    out[None] = int(_idle_within(busy, lo, hi)) - tops
    return out


def innermost(spans, gaps):
    """For each ``(start, end)`` gap, the name of the shortest span that
    covers its midpoint (None if none does)."""
    out = []
    for s, e in gaps:
        mid = (s + e) // 2
        inside = [x for x in spans if x["start_ns"] <= mid <= x["end_ns"]]
        out.append(min(inside, key=lambda x: x["end_ns"] - x["start_ns"])
                   ["name"] if inside else None)
    return out
