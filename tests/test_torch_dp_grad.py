"""The port's differentiable DP (``ops/dp.py`` autograd over the plain
passes, on CPU tensors) against the JAX package's ``custom_vjp``s.

* ``expected_alignment``'s values and VJP (``return_gap`` both ways,
  including the gradient of ``Et``) against ``jax.vjp``, and
  ``alignment_score``'s gradient and grad-of-grad-norm against
  ``jax.grad``, with ``backend="scan"``, fp64;
* one case against the TPU training kernels (``backend="pallas_bm"``,
  phased, in Pallas interpret mode) at fp32.

Tolerance: atol 1e-9 at fp64 (the same recurrences; see
tests/test_torch_dp_train.py); the pallas_bm case atol 2e-5 at fp32, as
tests/test_dp_bm_phased.py holds pallas_bm to the scan.  Each mode x
operator runs once, the three ragged shapes in turn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepblast_torch.ops import dp as tdp
from deepblast_tpu.ops import dp as jdp
from deepblast_tpu.ops import dp_bm_train
import torch_threads  # noqa: F401  (PyTorch threads a worker)

ATOL = 1e-9
SHAPES = [(3, 24, 17), (2, 40, 33), (2, 33, 40)]
MODES = ["nw", "sw"]
OPS = ["softmax", "sparsemax", "hardmax"]
# each mode x operator once, the three shapes in turn
CASES = [(SHAPES[i % 3], mode, op)
         for i, (mode, op) in enumerate((m, o) for m in MODES for o in OPS)]


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
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    for b, (n, m) in enumerate(zip(ln, lm)):
        np.testing.assert_allclose(got[b, :n, :m], want[b, :n, :m], rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(got[b, n:], 0.0)
        np.testing.assert_array_equal(got[b, :, m:], 0.0)


@pytest.mark.parametrize("return_gap", [False, True])
@pytest.mark.parametrize("shape,mode,operator", CASES)
def test_expected_alignment_vjp_matches_jax(shape, mode, operator,
                                            return_gap):
    B, N, M = shape
    theta, A, ln, lm, Zt, Za, Et = _problem(N * M + B, B, N, M)
    kw = dict(mode=mode, operator=operator)
    lens = (jnp.asarray(ln), jnp.asarray(lm))

    def f(t, a, e):
        return jdp.expected_alignment(t, a, lens, e, backend="scan",
                                      return_gap=return_gap, **kw)

    out_j, vjp = jax.vjp(f, jnp.asarray(theta), jnp.asarray(A),
                         jnp.asarray(Et))
    cts = (jnp.asarray(Zt), jnp.asarray(Za)) if return_gap \
        else jnp.asarray(Zt)
    g_j = vjp(cts)

    t = torch.tensor(theta, requires_grad=True)
    a = torch.tensor(A, requires_grad=True)
    e = torch.tensor(Et, requires_grad=True)
    out_t = tdp.expected_alignment(t, a, (ln, lm), e, return_gap=return_gap,
                                   **kw)
    if return_gap:
        loss = (out_t[0] * torch.tensor(Zt)).sum() + \
            (out_t[1] * torch.tensor(Za)).sum()
    else:
        out_t, out_j = (out_t,), (out_j,)
        loss = (out_t[0] * torch.tensor(Zt)).sum()
    for got, want in zip(out_t, out_j):
        _natural(got, want, ln, lm)
    g_t = torch.autograd.grad(loss, (t, a, e))
    _natural(g_t[0], g_j[0], ln, lm)
    _natural(g_t[1], g_j[1], ln, lm)
    np.testing.assert_allclose(g_t[2].numpy(), np.asarray(g_j[2]), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("shape,mode,operator", CASES)
def test_alignment_score_two_orders_match_jax(shape, mode, operator):
    """grad of Vt, and the grad of its squared norm (the second order that
    runs the adjoint passes under create_graph), as
    tests/test_dp_bm_phased.py:122-151 checks pallas_bm."""
    B, N, M = shape
    theta, A, ln, lm, *_ = _problem(N + M * B, B, N, M)
    kw = dict(mode=mode, operator=operator)
    lens = (jnp.asarray(ln), jnp.asarray(lm))

    def score(t, a):
        return jnp.sum(jdp.alignment_score(t, a, lens, backend="scan", **kw))

    def s2(t, a):
        g = jax.grad(score)(t, a)
        return jnp.sum(g * g)

    g1_j = jax.grad(score, argnums=(0, 1))(jnp.asarray(theta),
                                           jnp.asarray(A))
    g2_j = jax.grad(s2, argnums=(0, 1))(jnp.asarray(theta), jnp.asarray(A))

    t = torch.tensor(theta, requires_grad=True)
    a = torch.tensor(A, requires_grad=True)
    vt = tdp.alignment_score(t, a, (ln, lm), **kw)
    g1 = torch.autograd.grad(vt.sum(), (t, a), create_graph=True)
    g2 = torch.autograd.grad((g1[0] * g1[0]).sum(), (t, a))
    for got, want in zip((*g1, *g2), (*g1_j, *g2_j)):
        _natural(got, want, ln, lm)


def test_expected_alignment_matches_pallas_bm_training_kernels(monkeypatch):
    """The JAX package's TPU training path (pallas_bm, phased kernels, in
    interpret mode) against the port at fp32: values and the gradient of
    sum(E * E) through the adjoint passes.  Two phases instead of eight:
    interpret mode costs seconds per phase, and
    tests/test_dp_bm_phased.py shows the phase plan does not change the
    result."""
    monkeypatch.setattr(dp_bm_train, "TRAIN_PHASES", 2)
    rng = np.random.default_rng(5)
    B, N, M = 2, 20, 15
    theta = rng.standard_normal((B, N, M)).astype(np.float32)
    A = (rng.standard_normal((B, N, M)) - 1.0).astype(np.float32)
    ln, lm = np.array([20, 13]), np.array([15, 11])
    lens = (jnp.asarray(ln), jnp.asarray(lm))

    def loss(t, a):
        E = jdp.expected_alignment(t, a, lens, backend="pallas_bm")
        return jnp.sum(E * E), E

    (_, E_j), g_j = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(theta), jnp.asarray(A))
    t = torch.tensor(theta, requires_grad=True)
    a = torch.tensor(A, requires_grad=True)
    E_t = tdp.expected_alignment(t, a, (ln, lm))
    g_t = torch.autograd.grad((E_t * E_t).sum(), (t, a))
    for got, want in ((E_t, E_j), *zip(g_t, g_j)):
        for b in range(B):
            np.testing.assert_allclose(
                got.detach().numpy()[b, :ln[b], :lm[b]],
                np.asarray(want)[b, :ln[b], :lm[b]], rtol=0, atol=2e-5)
