"""The port's ``deepblast-benchmark`` (``deepblast_torch.cli.benchmark``)
and its timing and profiling utilities against the JAX package's.

* ``run_config`` draws the JAX inputs bit for bit and times the JAX
  function at each depth: both ``time_op``s are replaced by a capture,
  and each captured op runs once (the port's plain passes, float32; the
  JAX package's default CPU backend, scan, float32).  Tolerance rtol 1e-4
  / atol 1e-6, float32's (the two libraries round exp and log apart);
  the decode stream is compared cell by cell through each backend's
  ``stream_cell``, since the JAX scan stream is ``(K, B, S)``.
* ``main``, with ``run_config`` replaced in both modules, requests the
  same shapes with the same menu labels for every sweep and menu, on the
  default backend, on ``pallas`` (where the menu is ignored) and on
  ``scan`` (which takes it); ``--backend scan --device cpu`` times the
  scan backend; the port's records have the JAX record's keys and the
  device's name; without a card it refuses to run unless ``--device cpu``
  asks.
* ``time_op`` runs ``reps x (iters + warmup)`` calls; ``trace`` writes a
  Chrome trace.
"""

import json

import numpy as np
import pytest
import torch

from deepblast_torch.cli import benchmark as tbench
from deepblast_torch.ops import dp as tdp
from deepblast_torch.utils import profiling, timing
from deepblast_tpu.cli import benchmark as jbench
from deepblast_tpu.ops import dp as jdp
import torch_threads  # noqa: F401  (PyTorch threads a worker)

SHAPE = (2, 12, 10)
RTOL, ATOL = 1e-4, 1e-6
MENUS = ["fp32", "d-bf16", "all-bf16", "i16"]


def _capture(monkeypatch, module):
    """Replace ``module.time_op`` by a capture of its ``(op, args)``."""
    seen = []

    def capture(op, *args, **kw):
        seen.append((op, args))
        return 0.5
    monkeypatch.setattr(module, "time_op", capture)
    return seen


@pytest.fixture(scope="module")
def jax_ops():
    """The JAX benchmark's inputs and op at each (mode, depth), captured
    from its ``run_config`` once for the module."""
    mp = pytest.MonkeyPatch()
    import deepblast_tpu.utils.timing as jtiming
    seen = _capture(mp, jtiming)
    out = {}
    for mode in ("nw", "sw"):
        for depth in tbench.DEPTHS:
            rec = jbench.run_config(*SHAPE, mode, None, depth, 1)
            out[mode, depth] = seen[-1] + (rec,)
    mp.undo()
    return out


def _cells(stream, cell, b, n, m):
    return np.array([[float(cell(stream, b, i, j)) for j in range(m)]
                     for i in range(n)])


@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("depth", ["fwd", "fwd+bwd", "decode", "train"])
def test_run_config_matches_jax(monkeypatch, jax_ops, mode, depth):
    jop, (jtheta, jA), jrec = jax_ops[mode, depth]
    seen = _capture(monkeypatch, timing)
    rec = tbench.run_config(*SHAPE, mode, None, depth, 1, device="cpu")
    op, (theta, A) = seen[0]
    # the inputs: the JAX draw bit for bit
    assert theta.dtype == A.dtype == torch.float32
    np.testing.assert_array_equal(theta.detach().numpy(), np.asarray(jtheta))
    np.testing.assert_array_equal(A.detach().numpy(), np.asarray(jA))
    assert rec == dict(jrec, device="cpu")

    got, want = op(theta, A), jop(jtheta, jA)
    if depth == "decode":
        _, jbe = jdp.get_backend(None)
        B, N, M = SHAPE
        for b in range(B):
            np.testing.assert_allclose(
                _cells(got, tdp.stream_cell, b, N, M),
                _cells(np.asarray(want), jbe["stream_cell"], b, N, M),
                rtol=RTOL, atol=ATOL)
        return
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


def _requests(monkeypatch, capsys, module, argv):
    """``(B, N, M)`` and ``dtype_menu`` of each record ``module.main``
    prints, with its ``run_config`` replaced."""
    asked = []

    def fake(B, N, M, mode, backend, depth, iters, reps=4, dtypes=None,
             **kw):
        asked.append((B, N, M, dtypes is None))
        return dict(B=B, N=N, M=M)
    monkeypatch.setattr(module, "run_config", fake)
    capsys.readouterr()
    assert module.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    recs = [json.loads(x) for x in lines if x.startswith("{")]
    return asked, [(r["B"], r["N"], r["M"], r["dtype_menu"]) for r in recs]


@pytest.mark.parametrize("sweep", ["batch", "length", "headline"])
@pytest.mark.parametrize("menu", MENUS)
@pytest.mark.parametrize("backend", [None, "pallas", "scan"])
def test_main_requests_match_jax(monkeypatch, capsys, sweep, menu, backend):
    argv = ["--sweep", sweep, "--dtype-menu", menu, "--batch-size", "3",
            "--length", "40"] + (["--backend", backend] if backend else [])
    want = _requests(monkeypatch, capsys, jbench, argv)
    got = _requests(monkeypatch, capsys, tbench, argv)
    assert got == want
    if backend == "pallas" and menu != "fp32":
        assert got[1][0][3] == f"{menu} (ignored: fp32 backend)"


def test_scan_raises_and_records_name_the_device(monkeypatch, capsys):
    """``--backend scan`` runs (it once raised) and the records name the
    device."""
    capsys.readouterr()
    assert tbench.main(["--backend", "scan", "--device", "cpu",
                        "--batch-size", "2", "--length", "6", "--iters", "1",
                        "--depth", "train", "--dtype-menu", "d-bf16"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["backend"] == "scan" and rec["dtype_menu"] == "d-bf16"
    assert rec["device"] == "cpu" and rec["seconds"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(["--batch-size", "2", "--length", "6"])
    capsys.readouterr()
    assert tbench.main(["--batch-size", "2", "--length", "6", "--iters",
                        "1", "--depth", "decode", "--backend", "pallas",
                        "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec["device"] == "cpu" and rec["seconds"] > 0
    assert rec["depth"] == "decode" and rec["backend"] == "pallas"
    assert rec["alignments_per_sec"] == pytest.approx(2 / rec["seconds"])


def test_time_op_counts_calls():
    calls = []
    x = torch.zeros(3)
    dt = timing.time_op(lambda t: calls.append(t.sum()), x, reps=3, iters=4,
                        warmup=2)
    assert len(calls) == 3 * (4 + 2) and dt > 0


def test_trace_and_timed(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("cumsum" in e.key for e in prof.key_averages())
