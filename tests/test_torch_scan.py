"""The port's ``scan`` backend (``deepblast_torch.ops.dp``, ``backend="scan"``)
against the JAX package's ``backend="scan"`` on the CPU.

* The DP at fp64, nw and sw x softmax, sparsemax and hardmax, ragged
  lengths, without and with the ``d=bfloat16`` menu: ``alignment_score``;
  ``expected_alignment`` with and without ``return_gap`` and its VJP
  (the ``Et`` gradient included); the gradient of the score and of its
  squared norm (the second order, through the adjoint passes); and
  ``expected_alignment_stream`` walked by ``traceback_stream`` against
  JAX's ``traceback`` of its E.
* What the backend ignores and where it runs: ``Q_DTYPE``, the
  ``stream`` and ``e`` knobs, the device (its passes are the plain ones
  on every device), float32 in, float32 out.
* Training and loading: ``fit`` under ``backend="scan"`` against the
  JAX trainer's scan; ``cli.train --backend scan`` -> ``load_model`` ->
  ``align`` / ``score_pairs`` / ``cli.search``; ``cli.benchmark
  --backend scan --device cpu`` at each depth against the JAX
  benchmark's ops (a JAX ``config.json`` with ``"backend": "scan"``:
  ``test_torch_config.py::test_load_model_refuses_unported_jax_fields``).

Tolerances: atol 1e-10 at fp64, with and without the menu (both rebuild
Q and Qd from the same differences rounded through bfloat16; measured
largest difference 4.4e-15, the menu's included); the benchmark's ops at
float32 rtol 1e-4 / atol 1e-6 as ``test_torch_benchmark.py``; the fit
trajectories rtol 1e-4 as ``test_fit_trajectory_variants_match_jax``;
tracebacks identical.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepblast_torch.cli import benchmark as tbench
from deepblast_torch.cli import search as tsearch
from deepblast_torch.cli import train as ttrain
from deepblast_torch.data import dataset as tds
from deepblast_torch.models.convert import params_from_jax
from deepblast_torch.ops import dp as tdp
from deepblast_torch.ops import dp_ref
from deepblast_torch.ops.menu import DTypeMenu
from deepblast_torch.train import trainer as ttrainer
from deepblast_torch.train.checkpoint import load_model
from deepblast_torch.utils import timing
from deepblast_tpu.cli import benchmark as jbench
from deepblast_tpu.data import dataset as jds
from deepblast_tpu.ops import dp as jdp
from deepblast_tpu.ops.dp_bm import DTypeMenu as JMenu
from deepblast_tpu.train import trainer as jtrainer
from deepblast_tpu.utils import timing as jtiming
from test_torch_benchmark import _capture, _cells
from test_torch_jax_model import _batch
from test_torch_train import (TINY, _count_calls, _Rec, _rows,
                              _same_trajectory, _write_tsv)
from test_train import fixture_frame
import torch_threads  # noqa: F401  (PyTorch threads a worker)

ATOL = 1e-10
SHAPES = [(3, 24, 17), (2, 40, 33), (2, 33, 48)]
CASES = [(SHAPES[i % 3], mode, op) for i, (mode, op) in enumerate(
    (m, o) for m in ("nw", "sw") for o in ("softmax", "sparsemax",
                                           "hardmax"))]


def _problem(seed, B, N, M):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((B, N, M))
    A = rng.standard_normal((B, N, M)) - 1.0
    ln = rng.integers(3, N + 1, size=B)
    lm = rng.integers(3, M + 1, size=B)
    ln[0], lm[0] = N, M
    Zt = rng.standard_normal((B, N, M))
    Za = rng.standard_normal((B, N, M))
    Et = rng.uniform(0.5, 1.5, size=B)
    return theta, A, ln, lm, Zt, Za, Et


def _natural(got, want, ln, lm):
    """``got`` (a port tensor) = ``want`` (a JAX array) at every valid
    cell of each pair, and zero past its lengths."""
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape and got.dtype == np.float64
    for b, (n, m) in enumerate(zip(ln, lm)):
        np.testing.assert_allclose(got[b, :n, :m], want[b, :n, :m], rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(got[b, n:], 0.0)
        np.testing.assert_array_equal(got[b, :, m:], 0.0)


@pytest.mark.parametrize("menu", [None, "d-bf16"])
@pytest.mark.parametrize("shape,mode,operator", CASES)
def test_scan_matches_jax(shape, mode, operator, menu):
    B, N, M = shape
    theta, A, ln, lm, Zt, Za, Et = _problem(N * M + B, B, N, M)
    jmenu = JMenu.make(d="bfloat16") if menu else None
    tmenu = DTypeMenu.make(d="bfloat16") if menu else None
    kw = dict(mode=mode, operator=operator)
    lens = (jnp.asarray(ln), jnp.asarray(lm))

    def f(t, a, e):
        return jdp.expected_alignment(t, a, lens, e, backend="scan",
                                      return_gap=True, dtypes=jmenu, **kw)

    @jax.jit
    def reference(t, a, e, zt, za):
        vt = jdp.alignment_score(t, a, lens, backend="scan", dtypes=jmenu,
                                 **kw)
        (E, EA), vjp = jax.vjp(f, t, a, e)
        # Et = 1: E and E_A are the score's gradient; the VJP along
        # (2E, 2E_A) is the gradient of its squared norm
        (G, GA), vjp1 = jax.vjp(f, t, a, jnp.ones_like(e))
        return (vt, E, EA, vjp((zt, za)), vjp((zt, jnp.zeros_like(za))),
                G, GA, vjp1((2 * G, 2 * GA)))

    (vt_j, E_j, EA_j, g_j, g0_j, G_j, GA_j, gg_j) = reference(
        *(jnp.asarray(x) for x in (theta, A, Et, Zt, Za)))

    tkw = dict(kw, backend="scan", dtypes=tmenu)
    t = torch.tensor(theta, requires_grad=True)
    a = torch.tensor(A, requires_grad=True)
    e = torch.tensor(Et, requires_grad=True)
    vt = tdp.alignment_score(t, a, (ln, lm), **tkw)
    assert vt.dtype == torch.float64
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vt_j),
                               rtol=0, atol=ATOL)
    E, EA = tdp.expected_alignment(t, a, (ln, lm), e, return_gap=True, **tkw)
    _natural(E, E_j, ln, lm)
    _natural(EA, EA_j, ln, lm)
    g = torch.autograd.grad((E * torch.tensor(Zt)).sum()
                            + (EA * torch.tensor(Za)).sum(), (t, a, e))
    E0 = tdp.expected_alignment(t, a, (ln, lm), e, **tkw)
    _natural(E0, E_j, ln, lm)
    g0 = torch.autograd.grad((E0 * torch.tensor(Zt)).sum(), (t, a, e))
    for got, want in ((g, g_j), (g0, g0_j)):
        _natural(got[0], want[0], ln, lm)
        _natural(got[1], want[1], ln, lm)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=0, atol=ATOL)

    g1 = torch.autograd.grad(vt.sum(), (t, a), create_graph=True)
    g2 = torch.autograd.grad((g1[0] * g1[0]).sum() + (g1[1] * g1[1]).sum(),
                             (t, a))
    for got, want in zip((*g1, *g2), (G_j, GA_j, *gg_j[:2])):
        _natural(got, want, ln, lm)

    with torch.no_grad():
        S = tdp.expected_alignment_stream(t, a, (ln, lm), e, **tkw)
    assert S.shape == (B, N + M - 1, N + 1) and S.dtype == torch.float64
    for b, (n, m) in enumerate(zip(ln, lm)):
        assert tdp.traceback_stream(S, int(n), int(m), b) == \
            jdp.traceback(np.asarray(E_j)[b, :n, :m])


def test_scan_menu_reads_d_only(monkeypatch):
    """``d`` rebuilds Q and Qd from rounded differences (the outputs
    move); ``stream`` and ``e`` change nothing, nor does ``Q_DTYPE``,
    as in JAX's scan (``_scan_with_dtypes``)."""
    theta, A, ln, lm, Zt, _, _ = _problem(7, 2, 20, 15)

    def run(menu):
        t = torch.tensor(theta, requires_grad=True)
        E = tdp.expected_alignment(t, torch.tensor(A), (ln, lm),
                                   backend="scan", dtypes=menu)
        return E, torch.autograd.grad((E * torch.tensor(Zt)).sum(), t)[0]

    base = run(None)
    for menu in (DTypeMenu.make(stream="int16", e="int16"),
                 DTypeMenu.make(stream="bfloat16", e="bfloat16")):
        for got, want in zip(run(menu), base):
            assert torch.equal(got, want)
    moved = run(DTypeMenu.make(d="bfloat16"))
    for got, want in zip(moved, base):
        assert 1e-6 < (got - want).abs().max() < 0.1
    monkeypatch.setattr(tdp, "Q_DTYPE", torch.bfloat16)
    for got, want in zip(run(None), base):
        assert torch.equal(got, want)


def test_scan_runs_the_plain_passes_on_any_device(monkeypatch):
    """Under ``scan`` the passes are picked by the backend, not by the
    device: the plain ones wherever the tensor is (a CUDA tensor never
    reaches ``dp_cuda``); the other backends keep the kernels there.
    float32 in, float32 out, and the Q streams float32 too."""
    meta = torch.empty(1, device="meta")
    assert tdp._passes(meta, tdp.BACKENDS["scan"]) is dp_ref
    with pytest.raises(ValueError, match="no DP implementation"):
        tdp._passes(meta, tdp.BACKENDS["pallas_bm"])
    assert tdp.get_backend("scan").stream
    theta, A, ln, lm, *_ = _problem(3, 2, 12, 9)
    t = torch.tensor(theta, dtype=torch.float32, requires_grad=True)
    a = torch.tensor(A, dtype=torch.float32)
    calls = []
    real = dp_ref.forward_q

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append(out[1].dtype)
        return out
    monkeypatch.setattr(dp_ref, "forward_q", spy)
    E = tdp.expected_alignment(t, a, (ln, lm), backend="scan")
    g = torch.autograd.grad(E.sum(), t)[0]
    assert E.dtype == g.dtype == torch.float32 and calls == [torch.float32]


def _fit(jax_bf16, port_bf16):
    """The JAX trainer (scan) and the port under ``backend="scan"`` from
    the same init on the same batches (``test_torch_train``'s TINY)."""
    jmodel = jtrainer.DeepBLAST(jtrainer.DeepBLASTConfig(
        backend="scan", dp_bf16_residuals=jax_bf16, **TINY))
    jmodel.state = jmodel.init()
    tmodel = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(
        backend="scan", dp_bf16_residuals=port_bf16, **TINY), device="cpu")
    assert (tmodel.dp_dtypes is None) == (port_bf16 == "auto")
    tmodel.lm.load_state_dict(params_from_jax(jmodel.state.lm_params))
    tmodel.aligner.load_state_dict(
        params_from_jax(jmodel.state.params["aligner"]))
    jrec, trec = _Rec(), _Rec()
    _, jhist = jmodel.fit(jds.TMAlignDataset(fixture_frame()),
                          jds.TMAlignDataset(fixture_frame()), logger=jrec)
    _, thist = tmodel.fit(tds.TMAlignDataset(_rows(fixture_frame())),
                          tds.TMAlignDataset(_rows(fixture_frame())),
                          logger=trec)
    return (trec.rows, thist), (jrec.rows, jhist)


def test_fit_under_scan_matches_jax():
    """``"auto"`` resolves to off under scan in both packages, and six
    steps and two validation epochs agree."""
    _same_trajectory(*_fit("auto", "auto"), rtol=1e-4)


def test_cli_train_scan_then_load_model_aligns(tmp_path, monkeypatch):
    """``cli.train --backend scan`` trains through the scan passes, lands
    in config.json, and the loaded model aligns (through the stream),
    scores and searches (``cli.search``) through them; no residual pass
    runs."""
    train, valid = tmp_path / "train.tsv", tmp_path / "valid.tsv"
    _write_tsv(train, fixture_frame(n_rows=8, seed=1))
    _write_tsv(valid, fixture_frame(n_rows=4, seed=2))
    out = tmp_path / "out"
    q = _count_calls(monkeypatch, dp_ref, "adjoint_backward_q")
    residual = [_count_calls(monkeypatch, dp_ref, name)
                for name in ("forward", "forward_score", "backward")]
    assert ttrain.main([
        "--train-pairs", str(train), "--valid-pairs", str(valid),
        "-o", str(out), "--embedding-dim", "16", "--hidden-dim", "16",
        "--batch-size", "4", "--epochs", "2", "--max-len", "64",
        "--learning-rate", "5e-3", "--device", "cpu",
        "--backend", "scan"]) == 0
    assert len(q) == 4          # 2 steps x 2 epochs
    with open(out / "config.json") as f:
        assert json.load(f)["backend"] == "scan"
    model = load_model(str(out), device="cpu")
    assert model.aligner.backend == "scan" and model.dp_dtypes is None
    bwd = _count_calls(monkeypatch, dp_ref, "backward_q")
    for x, y in (("ACDEFGHIKL", "ACDFGHIKLM"), ("MKTAYIAK", "MKTAYK")):
        s = model.align(x, y)
        assert s.count(":") + s.count("1") == len(x)
        assert s.count(":") + s.count("2") == len(y)
    assert len(bwd) == 2
    batch = _batch(model.tokenizer)
    assert torch.isfinite(model.score_pairs(batch)).all()
    fwd = _count_calls(monkeypatch, dp_ref, "forward_q")
    with open(tmp_path / "q.fa", "w") as f:
        f.write(">q0\nACDEFGHIKL\n>q1\nMKTAYIAK\n")
    hits = tmp_path / "hits.tsv"
    assert tsearch.main(["--query-fasta", str(tmp_path / "q.fa"),
                         "--db-fasta", str(tmp_path / "q.fa"),
                         "--load-from-checkpoint", str(out),
                         "--output-file", str(hits), "--device", "cpu"]) == 0
    assert len(hits.read_text().splitlines()) == 4 and fwd
    assert not any(residual)


@pytest.mark.parametrize("depth", ["fwd", "fwd+bwd", "decode", "train"])
def test_benchmark_scan_matches_jax(monkeypatch, depth):
    """``run_config`` under ``--backend scan --device cpu``: the JAX
    inputs and the JAX scan's function at each depth (the decode stream
    cell by cell)."""
    shape = (2, 12, 10)
    jseen = _capture(monkeypatch, jtiming)
    jrec = jbench.run_config(*shape, "nw", "scan", depth, 1)
    jop, (jtheta, jA) = jseen[0]
    seen = _capture(monkeypatch, timing)
    rec = tbench.run_config(*shape, "nw", "scan", depth, 1, device="cpu")
    op, (theta, A) = seen[0]
    assert rec == dict(jrec, device="cpu")
    np.testing.assert_array_equal(theta.detach().numpy(), np.asarray(jtheta))
    got, want = op(theta, A), jop(jtheta, jA)
    if depth == "decode":
        _, jbe = jdp.get_backend("scan")
        for b in range(shape[0]):
            np.testing.assert_allclose(
                _cells(got, tdp.stream_cell, b, *shape[1:]),
                _cells(np.asarray(want), jbe["stream_cell"], b, *shape[1:]),
                rtol=1e-4, atol=1e-6)
        return
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-6)
