"""The port's recorder (``deepblast_torch.utils.profiling``): spans and
counters off and on, their ids, autograd's threads, the profiler's clock,
the spans and counters of ``fit`` and ``align``, and the trace.  Tiny
sizes on the CPU, where no span has a device time."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deepblast_torch.data.dataset import TMAlignDataset, make_batches
from deepblast_torch.ops import dp as tdp
from deepblast_torch.train import trainer as ttrainer
from deepblast_torch.utils import profiling
from synthetic_pairs import homolog_row
import torch_threads  # noqa: F401  (PyTorch threads a worker)

TINY = dict(embedding_dim=8, hidden_dim=8, layers=1, k_size=3,
            vocab_size=32, lm_type="embed", batch_size=2,
            learning_rate=5e-3, epochs=1, scheduler="none", max_len=64,
            pad_multiple=8, mask_gaps=True, dropout=0.0, grad_clip=1.0)
FIT_SPANS = {"fit.copy_in", "fit.issue", "lm", "heads", "dp", "loss",
             "backward", "optimizer", "fit.batch"}


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.drain()
    yield
    profiling.drain()


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(5)
    return [homolog_row(rng, f"r{i}", 8, 20) for i in range(4)]


def _model():
    return ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(**TINY),
                              device="cpu").init()


def test_off_is_a_shared_noop(monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", lambda **k: made.append(k))
    a = profiling.span("lm", device=True)
    with a, profiling.span("align"):
        profiling.count("fit.steps")
    assert a is profiling.span("heads") and not profiling.active()
    assert made == []
    assert profiling.drain() == {"spans": [], "counters": {}}


def test_nesting_ids_and_counters():
    with profiling.recording():
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.recording():     # blocks nest
                    with profiling.span("c"):
                        profiling.count("n", 2)
            profiling.count("n")
        with profiling.span("d"):
            pass
    with profiling.span("after"):
        profiling.count("n")
    got = profiling.drain()
    a, b, c, d = got["spans"]
    assert [s["name"] for s in (a, b, c, d)] == ["a", "b", "c", "d"]
    assert (a["parent"], b["parent"], c["parent"], d["parent"]) == \
        (None, a["id"], b["id"], None)
    assert (a["root"], b["root"], c["root"], d["root"]) == \
        (a["id"], a["id"], a["id"], d["id"])
    assert a["start_ns"] <= b["start_ns"] <= c["start_ns"] \
        <= c["end_ns"] <= b["end_ns"] <= a["end_ns"] <= d["start_ns"]
    assert all(s["device_s"] is None for s in got["spans"])
    assert got["counters"] == {"n": 3}
    assert profiling.drain() == {"spans": [], "counters": {}}


def test_spans_of_other_threads_hang_under_the_recording_threads():
    """A thread with no open span of its own (autograd's device threads)
    takes the span open on the recording thread as parent; the DP's
    backward, run by autograd, sits under ``backward``."""
    theta = torch.rand((1, 5, 4), dtype=torch.float64, requires_grad=True)
    A = torch.full((1, 5, 4), -1.0, dtype=torch.float64)
    with profiling.recording():
        with profiling.span("backward"):
            t = threading.Thread(target=lambda: profiling.span("x")
                                 .__enter__().__exit__(None, None, None))
            t.start()
            t.join(timeout=10)
        E = tdp.expected_alignment(theta, A)
        with profiling.span("backward"):
            E.sum().backward()
    assert not t.is_alive()
    spans = profiling.drain()["spans"]
    first, x, fwd, second, bwd = spans
    assert [s["name"] for s in spans] == ["backward", "x", "dp",
                                          "backward", "dp"]
    assert (x["parent"], x["root"]) == (first["id"], first["id"])
    assert fwd["parent"] is None
    assert (bwd["parent"], bwd["root"]) == (second["id"], second["id"])


def test_span_stamps_bracket_the_profilers_event():
    """``time.time_ns()`` is the clock of the profiler's events."""
    with profiling.recording(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("clocked"):
            torch.ones(64).cumsum(0)
    (s,) = profiling.drain()["spans"]
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "clocked"]
    assert s["start_ns"] <= ev.start_ns() <= ev.start_ns() \
        + ev.duration_ns() <= s["end_ns"]


def test_fit_records_one_root_a_step_and_counts_padding(rows):
    model = _model()
    ds = TMAlignDataset(rows)
    with profiling.recording():
        model.fit(ds)
    got = profiling.drain()
    spans = got["spans"]
    steps = [s for s in spans if s["name"] == "step"]
    assert len(steps) == 2 and all(s["parent"] is None for s in steps)
    for st in steps:
        under = {s["name"] for s in spans
                 if s["root"] == st["id"] and s is not st}
        assert FIT_SPANS <= under
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] == "dp" and s["parent"] is not None and \
                by_id[s["parent"]]["name"] == "backward":
            break
    else:
        raise AssertionError("no dp span under backward")
    batches = list(make_batches(ds, TINY["batch_size"], shuffle=True,
                                seed=model.config.seed,
                                pad_multiple=TINY["pad_multiple"]))
    want = {"fit.steps": len(batches),
            "fit.residues": sum(int(b["x_len"].sum() + b["y_len"].sum())
                                for b in batches),
            "fit.residues_padded": sum(b["x"].size + b["y"].size
                                       for b in batches)}
    assert got["counters"] == want


def test_fit_counts_nothing_while_off(monkeypatch):
    """Off, a step's counting is one test of the flag: no rows taken."""
    model = _model()
    taken = []
    monkeypatch.setattr(model, "_rows", lambda b: taken.append(b) or b)
    model._count_step(None)
    assert taken == []
    assert profiling.drain() == {"spans": [], "counters": {}}


def test_align_records_the_request_in_order(rows):
    model = _model()
    with profiling.recording():
        model.align(rows[0][5], rows[0][6])
    got = profiling.drain()
    spans = got["spans"]
    assert [s["name"] for s in spans] == [
        "align", "align.prepare", "lm", "lm", "heads", "dp",
        "align.copy_out", "align.walk"]
    assert {s["root"] for s in spans} == {spans[0]["id"]}
    assert all(s["parent"] == spans[0]["id"] for s in spans[1:])
    assert all(a["end_ns"] <= b["start_ns"]
               for a, b in zip(spans[1:], spans[2:]))
    assert got["counters"] == {}


def test_trace_shows_the_spans_and_keeps_none(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        assert profiling.active()
        with profiling.span("traced.block"):
            torch.ones(8).cumsum(0)
    assert any(e.key == "traced.block" for e in prof.key_averages())
    assert not profiling.active()
    assert profiling.drain() == {"spans": [], "counters": {}}


def test_trace_inside_a_recording_block_leaves_its_spans(tmp_path):
    with profiling.recording():
        with profiling.trace(str(tmp_path)):
            with profiling.span("traced.block"):
                profiling.count("n")
        assert profiling.active()
    got = profiling.drain()
    assert [s["name"] for s in got["spans"]] == ["traced.block"]
    assert got["counters"] == {"n": 1}


def test_a_span_that_ends_after_recording_is_not_kept():
    with profiling.recording():
        late = profiling.span("late").__enter__()
        with profiling.span("kept"):
            pass
    late.__exit__(None, None, None)
    assert [s["name"] for s in profiling.drain()["spans"]] == ["kept"]
