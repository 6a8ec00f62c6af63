"""The port's training passes (ops/dp_ref.py) and their autograd
(ops/dp.py) on CPU tensors, against the JAX package's scan passes.

* the plain passes — backward with the gap output, the adjoint forward
  (with a Za stream and with None) and the adjoint backward — against
  ``dp_scan``'s passes and the dispatcher's ``_gap_mul`` at every cell
  of the band: the port's stream is the scan stream with its first two
  axes swapped (port ``[b, i+j, i+1]``, scan ``[i+j, b, i+1]``);
* the plain unskew (the unskew kernel's plain version);
* ``torch.autograd.gradcheck`` / ``gradgradcheck`` of
  ``expected_alignment`` and ``alignment_score`` (softmax only: finite
  differences break at the kinks of sparsemax and hardmax).

Tolerance: atol 1e-9 at fp64 (both sides run the same recurrences; the
port takes the max3 of the differences (Dx, Dm, 0) and the Hessian
product of the tangent differences (Dxd, Dmd, 0), where the scan takes
them of the raw arguments, which moves only the last bits).
tests/test_torch_dp_grad.py holds the VJPs against ``jax.vjp``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepblast_torch.ops import dp as tdp
from deepblast_torch.ops import dp_ref
from deepblast_torch.ops.skew import skew as tskew
from deepblast_tpu.ops import dp as jdp
from deepblast_tpu.ops import dp_scan
from deepblast_tpu.ops.skew import skew as jskew
import torch_threads  # noqa: F401  (PyTorch threads a worker)

ATOL = 1e-9
SHAPES = [(3, 24, 17), (2, 40, 33), (2, 33, 40)]
MODES = ["nw", "sw"]
OPS = ["softmax", "sparsemax", "hardmax"]


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


def _band(port, scan, ln, lm):
    """Compare a port stream (B, K, S) with a scan stream (K, B, S) at
    every cell of each pair's band."""
    scan = np.transpose(np.asarray(scan), (1, 0, 2))
    port = port.numpy()
    for b, (n, m) in enumerate(zip(ln, lm)):
        for i in range(n):
            np.testing.assert_allclose(port[b, i:i + m, i + 1],
                                       scan[b, i:i + m, i + 1],
                                       rtol=0, atol=ATOL)


def _natural(got, want, ln, lm):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    for b, (n, m) in enumerate(zip(ln, lm)):
        np.testing.assert_allclose(got[b, :n, :m], want[b, :n, :m], rtol=0,
                                   atol=ATOL)
        np.testing.assert_array_equal(got[b, n:], 0.0)
        np.testing.assert_array_equal(got[b, :, m:], 0.0)


@pytest.mark.parametrize("B,N,M", SHAPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("operator", OPS)
def test_plain_passes_match_scan(B, N, M, mode, operator):
    theta, A, ln, lm, Zt, Za, Et = _problem(B * N + M, B, N, M)
    kw = dict(mode=mode, operator=operator)
    jl, jm = jnp.asarray(ln), jnp.asarray(lm)
    _, qs = dp_scan.forward_scan(jskew(jnp.asarray(theta)),
                                 jskew(jnp.asarray(A)), jl, jm, **kw)
    E_j = dp_scan.backward_scan(jnp.asarray(Et), qs, jl, jm, mode=mode)
    EA_j = jdp._gap_mul(E_j, qs[0], qs[2])

    tl = torch.tensor(ln, dtype=torch.int32)
    tm = torch.tensor(lm, dtype=torch.int32)
    _, dx, dm = dp_ref.forward(tskew(torch.tensor(theta)),
                               tskew(torch.tensor(A)), tl, tm, **kw)
    E_t, EA_t = dp_ref.backward(dx, dm, tl, tm, torch.tensor(Et),
                                want_gap=True, **kw)
    _band(E_t, E_j, ln, lm)
    _band(EA_t, EA_j, ln, lm)
    E_only, none = dp_ref.backward(dx, dm, tl, tm, torch.tensor(Et), **kw)
    assert none is None and torch.equal(E_only, E_t)

    zt_t, za_t = tskew(torch.tensor(Zt)), tskew(torch.tensor(Za))
    zt_j, za_j = jskew(jnp.asarray(Zt)), jskew(jnp.asarray(Za))
    for za_port, za_scan in ((za_t, za_j), (None, jnp.zeros_like(zt_j))):
        vtd_j, qds = dp_scan.adjoint_forward_scan(qs, zt_j, za_scan, jl, jm,
                                                  **kw)
        vtd_t, dxd, dmd = dp_ref.adjoint_forward(dx, dm, zt_t, za_port, tl,
                                                 tm, **kw)
        np.testing.assert_allclose(vtd_t.numpy(), np.asarray(vtd_j), rtol=0,
                                   atol=ATOL)
        Ed_j = dp_scan.adjoint_backward_scan(E_j, qs, qds, jl, jm, mode=mode)
        EdA_j = jdp._gap_mul(Ed_j, qs[0], qs[2]) + jdp._gap_mul(
            E_j, qds[0], qds[2])
        Ed_t, EdA_t = dp_ref.adjoint_backward(dx, dm, dxd, dmd, E_t, tl, tm,
                                              **kw)
        _band(Ed_t, Ed_j, ln, lm)
        _band(EdA_t, EdA_j, ln, lm)
        for t in (dxd, dmd, Ed_t, EdA_t):
            assert torch.isfinite(t).all()


@pytest.mark.parametrize("B,N,M", SHAPES)
def test_unskew_inverts_skew(B, N, M):
    """unskew (the plain version of the unskew kernel):
    ``out[b, i, j] = s[b, i+j, i+1]``, the inverse of skew on every cell."""
    x = torch.tensor(np.random.default_rng(B).standard_normal((B, N, M)))
    s = tskew(x)
    u = dp_ref.unskew(s, N, M)
    torch.testing.assert_close(u, x, rtol=0, atol=0)
    i, j = N // 2, M - 1
    assert u[1, i, j] == s[1, i + j, i + 1]


@pytest.mark.parametrize("mode", MODES)
def test_gradcheck_softmax(mode):
    rng = np.random.default_rng(3)
    B, N, M = 2, 6, 5
    t = torch.tensor(rng.standard_normal((B, N, M)), requires_grad=True)
    a = torch.tensor(rng.standard_normal((B, N, M)) - 1.0,
                     requires_grad=True)
    e = torch.tensor(rng.uniform(0.5, 1.5, B), requires_grad=True)
    lens = (np.array([6, 4]), np.array([5, 3]))
    kw = dict(mode=mode, operator="softmax")
    assert torch.autograd.gradcheck(
        lambda t, a, e: tdp.expected_alignment(t, a, lens, e, **kw),
        (t, a, e))
    assert torch.autograd.gradcheck(
        lambda t, a: tdp.expected_alignment(t, a, lens, return_gap=True,
                                            **kw), (t, a))
    assert torch.autograd.gradcheck(
        lambda t, a: tdp.alignment_score(t, a, lens, **kw), (t, a))
    assert torch.autograd.gradgradcheck(
        lambda t, a: tdp.alignment_score(t, a, lens, **kw), (t, a))


def test_expected_alignment_grads_flow_only_where_asked():
    """No cotangent for the gap output gives the Za-free adjoint; an
    unused output and an input without grad are handled."""
    rng = np.random.default_rng(9)
    theta = torch.tensor(rng.standard_normal((2, 7, 6)), requires_grad=True)
    A = torch.tensor(rng.standard_normal((2, 7, 6)) - 1.0)
    E, EA = tdp.expected_alignment(theta, A, return_gap=True)
    (g,) = torch.autograd.grad(E.sum(), theta, retain_graph=True)
    E2 = tdp.expected_alignment(theta, A)
    (g2,) = torch.autograd.grad(E2.sum(), theta)
    torch.testing.assert_close(g, g2, rtol=0, atol=1e-12)
    (g3,) = torch.autograd.grad(EA.sum(), theta)
    assert torch.isfinite(g3).all() and g3.abs().sum() > 0
