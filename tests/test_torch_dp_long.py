"""The port's long-sequence backend (``pallas`` / ``pallas_long``: the
Q-stream passes) on the CPU against the JAX package's round-1 Pallas
kernels, run in interpret mode as tests/test_dp_pallas.py runs them.

* each plain Q pass of ``ops/dp_ref.py`` against ``dp_pallas``'s
  ``forward_pallas``, ``backward_pallas`` (+ ``_backward_v2``'s gap
  product), ``adjoint_forward_pallas`` and ``adjoint_backward_pallas``
  (+ ``_adjoint_backward_v2``'s ``EdA``) on the same inputs, with the TPU
  stream padding (rows to a multiple of 8, slots to 128 lanes, batch to 8)
  stripped;
* the dispatcher: ``expected_alignment`` (values, VJP with and without
  the gap output) and ``alignment_score`` (first and second order) with
  ``backend="pallas_long"`` against ``deepblast_tpu.ops.dp`` with the same
  backend;
* ``DeepBLAST.align`` under ``pallas_long`` = under the default backend,
  and the ``fit`` trajectory against the JAX trainer's, both with
  ``backend="pallas_long"``.

The plain-pass tests run the Pallas kernels with their default 8-row
blocks (the carries across blocks included); the dispatcher and trainer
tests, which hold the same kernels through ``jax.vjp``/``fit``, run them
with 1-row blocks (``DIAG_UNROLL = 1``, the kernels' ``T == 1`` form):
interpret mode compiles each unrolled block, and that keeps the file near
a minute on one core.

Tolerance: rtol/atol 2e-5 at fp32, as tests/test_dp_pallas.py holds the
pallas backends to the scan (two libraries' exp and log); the trajectory
rtol 1e-4 as tests/test_torch_train.py.  Q and Qd are compared at every
slot of the port's ``(B, K, S)`` stream: both packages write finite values
outside the band from the same masked rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepblast_torch.data import dataset as tds
from deepblast_torch.models.convert import params_from_jax
from deepblast_torch.ops import dp as tdp
from deepblast_torch.ops import dp_ref
from deepblast_torch.ops.skew import skew
from deepblast_torch.train import trainer as ttrainer
from deepblast_tpu.data import dataset as jds
from deepblast_tpu.ops import dp as jdp
from deepblast_tpu.ops import dp_pallas
from deepblast_tpu.train import trainer as jtrainer
from test_torch_train import TINY, _Rec, _rows
from test_train import fixture_frame
import torch_threads  # noqa: F401  (PyTorch threads a worker)

TOL = dict(rtol=2e-5, atol=2e-5)
# mode x operator: NW and SW with softmax, NW with sparsemax and hardmax
CASES = [("nw", "softmax"), ("sw", "softmax"), ("nw", "sparsemax"),
         ("nw", "hardmax")]
SHAPES = [(4, 9, 7), (3, 24, 17)]
# each mode x operator once, the two shapes in turn
PASS_CASES = [(SHAPES[i % 2], mode, op) for i, (mode, op) in enumerate(CASES)]


@pytest.fixture
def one_row_blocks(monkeypatch):
    monkeypatch.setattr(dp_pallas, "DIAG_UNROLL", 1)


def _problem(seed, B, N, M):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    theta = rng.standard_normal((B, N, M)).astype(f32)
    A = (rng.standard_normal((B, N, M)) - 1.0).astype(f32)
    ln = rng.integers(3, N + 1, size=B)
    lm = rng.integers(3, M + 1, size=B)
    ln[0], lm[0] = N, M
    Zt = rng.standard_normal((B, N, M)).astype(f32)
    Za = rng.standard_normal((B, N, M)).astype(f32)
    Et = rng.uniform(0.5, 1.5, size=B).astype(f32)
    return theta, A, ln, lm, Zt, Za, Et


def _port(s, B, K, S):
    """A TPU ``(K2, Bp, L)`` stream -> the port's ``(B, K, S)``."""
    return torch.tensor(np.asarray(s)[:K, :B, :S].transpose(1, 0, 2).copy())


def _tpu(t, like):
    """The port's ``(B, K, S)`` stream -> zero-padded ``(K2, Bp, L)``."""
    B, K, S = t.shape
    out = np.zeros(like.shape, np.float32)
    out[:K, :B, :S] = t.numpy().transpose(1, 0, 2)
    return jnp.asarray(out)


def _same(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape,mode,operator", PASS_CASES)
def test_plain_q_passes_match_dp_pallas(shape, mode, operator):
    B, N, M = shape
    K, S = N + M - 1, N + 1
    theta, A, ln, lm, Zt, Za, Et = _problem(B * N + M, B, N, M)
    jl, jm = jnp.asarray(ln), jnp.asarray(lm)
    tl = torch.tensor(ln, dtype=torch.int32)
    tm = torch.tensor(lm, dtype=torch.int32)
    kw = dict(mode=mode, operator=operator)

    # the relayout (TPU row 19): the port's skew is skew_input unpadded
    th_j, A_j = dp_pallas.skew_input(theta), dp_pallas.skew_input(A)
    th_t, A_t = skew(torch.tensor(theta)), skew(torch.tensor(A))
    assert torch.equal(_port(th_j, B, K, S), th_t)
    assert torch.equal(_port(A_j, B, K, S), A_t)

    vt_j, qs_j = dp_pallas.forward_pallas(th_j, A_j, jl, jm, **kw)
    vt_t, *qs_t = dp_ref.forward_q(th_t, A_t, tl, tm, **kw)
    _same(vt_t, vt_j)
    for got, want in zip(qs_t, qs_j):
        _same(got, _port(want, B, K, S))

    # each reverse pass on the same inputs: the JAX streams, unpadded
    qs = [_port(q, B, K, S) for q in qs_j]
    E_j, EA_j = dp_pallas._backward_v2(jnp.asarray(Et), qs_j, jl, jm,
                                       mode=mode, want_gap=True)
    E_t, EA_t = dp_ref.backward_q(*qs, tl, tm, torch.tensor(Et), mode=mode,
                                  want_gap=True)
    _same(E_t, _port(E_j, B, K, S))
    _same(EA_t, _port(EA_j, B, K, S))
    assert torch.equal(dp_ref.backward_q(*qs, tl, tm, torch.tensor(Et),
                                         mode=mode)[0], E_t)

    zt_t, za_t = skew(torch.tensor(Zt)), skew(torch.tensor(Za))
    for za in (za_t, None):     # None: the TPU's zeros stream
        zt_j = _tpu(zt_t, th_j)
        za_j = _tpu(torch.zeros_like(zt_t) if za is None else za, th_j)
        vtd_j, qds_j = dp_pallas.adjoint_forward_pallas(qs_j, zt_j, za_j,
                                                        jl, jm, **kw)
        vtd_t, *qds_t = dp_ref.adjoint_forward_q(*qs, zt_t, za, tl, tm, **kw)
        _same(vtd_t, vtd_j)
        for got, want in zip(qds_t, qds_j):
            _same(got, _port(want, B, K, S))

    qds = [_port(q, B, K, S) for q in qds_j]
    Ed_j, EdA_j = dp_pallas._adjoint_backward_v2(E_j, qs_j, qds_j, jl, jm,
                                                 mode=mode)
    Ed_t, EdA_t = dp_ref.adjoint_backward_q(*qs, *qds, _port(E_j, B, K, S),
                                            tl, tm, mode=mode)
    _same(Ed_t, _port(Ed_j, B, K, S))
    _same(EdA_t, _port(EdA_j, B, K, S))


def _natural(got, want, ln, lm):
    got = got.detach().numpy()
    want = np.asarray(want)
    for b, (n, m) in enumerate(zip(ln, lm)):
        np.testing.assert_allclose(got[b, :n, :m], want[b, :n, :m], **TOL)
        np.testing.assert_array_equal(got[b, n:], 0.0)
        np.testing.assert_array_equal(got[b, :, m:], 0.0)


@pytest.mark.parametrize("return_gap", [False, True])
@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_expected_alignment_matches_jax_pallas_long(one_row_blocks, mode,
                                                    return_gap):
    """Values and the VJP (theta, A and Et) through the Q passes."""
    B, N, M = 3, 24, 17
    theta, A, ln, lm, Zt, Za, Et = _problem(7 + B * N, B, N, M)
    lens = (jnp.asarray(ln), jnp.asarray(lm))

    def f(t, a, e):
        return jdp.expected_alignment(t, a, lens, e, mode=mode,
                                      backend="pallas_long",
                                      return_gap=return_gap)

    out_j, vjp = jax.vjp(f, jnp.asarray(theta), jnp.asarray(A),
                         jnp.asarray(Et))
    g_j = vjp((jnp.asarray(Zt), jnp.asarray(Za)) if return_gap
              else jnp.asarray(Zt))

    t = torch.tensor(theta, requires_grad=True)
    a = torch.tensor(A, requires_grad=True)
    e = torch.tensor(Et, requires_grad=True)
    out_t = tdp.expected_alignment(t, a, (ln, lm), e, mode=mode,
                                   backend="pallas_long",
                                   return_gap=return_gap)
    if not return_gap:
        out_t, out_j = (out_t,), (out_j,)
    loss = sum((o * torch.tensor(z)).sum() for o, z in zip(out_t, (Zt, Za)))
    for got, want in zip(out_t, out_j):
        _natural(got, want, ln, lm)
    g_t = torch.autograd.grad(loss, (t, a, e))
    _natural(g_t[0], g_j[0], ln, lm)
    _natural(g_t[1], g_j[1], ln, lm)
    np.testing.assert_allclose(g_t[2].numpy(), np.asarray(g_j[2]), **TOL)


@pytest.mark.parametrize("mode", ["nw", "sw"])
def test_alignment_score_two_orders_match_jax_pallas_long(one_row_blocks,
                                                         mode):
    """Vt, its gradient (the Q backward) and the gradient of the gradient's
    squared norm (the Q adjoint passes under create_graph)."""
    B, N, M = 3, 24, 17
    theta, A, ln, lm, *_ = _problem(3 + N + M, B, N, M)
    lens = (jnp.asarray(ln), jnp.asarray(lm))
    kw = dict(mode=mode, backend="pallas_long")

    def score(t, a):
        return jnp.sum(jdp.alignment_score(t, a, lens, **kw))

    def s2(t, a):
        g = jax.grad(score)(t, a)
        return jnp.sum(g * g)

    args = (jnp.asarray(theta), jnp.asarray(A))
    vt_j = jdp.alignment_score(*args, lens, **kw)
    g1_j = jax.grad(score, argnums=(0, 1))(*args)
    g2_j = jax.grad(s2, argnums=(0, 1))(*args)

    t = torch.tensor(theta, requires_grad=True)
    a = torch.tensor(A, requires_grad=True)
    vt = tdp.alignment_score(t, a, (ln, lm), **kw)
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(vt_j), **TOL)
    g1 = torch.autograd.grad(vt.sum(), (t, a), create_graph=True)
    g2 = torch.autograd.grad((g1[0] * g1[0]).sum(), (t, a))
    for got, want in zip((*g1, *g2), (*g1_j, *g2_j)):
        _natural(got, want, ln, lm)


def test_align_under_pallas_long_equals_default():
    """The natural expected alignment + traceback of the Q backend gives
    the default backend's stream traceback states."""
    cfg = dict(TINY, dropout=0.5)
    model = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(**cfg),
                               device="cpu").init()
    long = ttrainer.DeepBLAST(
        ttrainer.DeepBLASTConfig(backend="pallas_long", **cfg), device="cpu")
    long.aligner.load_state_dict(model.aligner.state_dict())
    long.lm.load_state_dict(model.lm.state_dict())
    rng = np.random.default_rng(3)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    for n, m in ((12, 9), (30, 41), (7, 7)):
        x = "".join(rng.choice(aa, n))
        y = "".join(rng.choice(aa, m))
        assert long.align(x, y) == model.align(x, y)


def test_fit_trajectory_matches_jax_pallas_long(one_row_blocks):
    """The same init and batches as test_torch_train's trajectory test,
    both trainers on ``backend="pallas_long"``: per-step train losses,
    validation losses and traceback stats over 6 steps."""
    jmodel = jtrainer.DeepBLAST(jtrainer.DeepBLASTConfig(
        backend="pallas_long", **TINY))
    jmodel.state = jmodel.init()
    tmodel = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(
        backend="pallas_long", **TINY), device="cpu")
    tmodel.lm.load_state_dict(params_from_jax(jmodel.state.lm_params))
    tmodel.aligner.load_state_dict(
        params_from_jax(jmodel.state.params["aligner"]))
    jrec, trec = _Rec(), _Rec()
    _, jhist = jmodel.fit(jds.TMAlignDataset(fixture_frame()),
                          jds.TMAlignDataset(fixture_frame()), logger=jrec)
    _, thist = tmodel.fit(tds.TMAlignDataset(_rows(fixture_frame())),
                          tds.TMAlignDataset(_rows(fixture_frame())),
                          logger=trec)
    assert [r[:2] for r in trec.rows] == [r[:2] for r in jrec.rows]
    assert sum(r[0] == "train_loss" for r in trec.rows) == 6
    np.testing.assert_allclose([r[2] for r in trec.rows],
                               [r[2] for r in jrec.rows], rtol=1e-4)
    for th, jh in zip(thist, jhist):
        assert th.keys() == jh.keys()
        np.testing.assert_allclose(list(th.values()), list(jh.values()),
                                   rtol=1e-4)
