"""Smoothed alignment DP: differentiable scores and expected alignments,
expected-alignment streams and the greedy traceback.

PyTorch counterpart of ``deepblast_tpu/ops/dp.py``:

* :func:`alignment_score` (``dp.py:317``) -> ``Vt (B,)``, differentiable
  twice: its gradient is the expected alignment (``_score_bwd``,
  ``dp.py:295-298``);
* :func:`expected_alignment` (``dp.py:335``) -> natural ``(B, N, M)``
  ``E`` (and ``E_A`` with ``return_gap``), differentiable: its VJP is the
  JVP along the cotangents by Hessian symmetry, run by the adjoint passes
  (``_expected_bwd``, ``dp.py:232-271``);
* :func:`expected_alignment_stream` (``dp.py:354``) -> ``(B, K, S)`` stream
  in the port's layout (``ops/skew.py``), read with :func:`stream_cell`;
  inference only;
* :func:`traceback`, :func:`traceback_stream` and :func:`_traceback_walk`
  (``dp.py:399-479``), with the documented border guard (``dp.py:407-412``).

The two ``jax.custom_vjp`` levels become two ``torch.autograd.Function``s:
``_Expected`` (forward: skew x2, forward, backward, unskew; backward: skew
of the cotangents, adjoint forward, adjoint backward, unskew x2) and
``_Score`` (forward: score-only forward; backward: ``_Expected`` itself,
so ``create_graph=True`` gives the second order).  ``_Expected``'s own
backward is ``once_differentiable``: like the JAX package, the DP goes no
deeper than second order.

For CUDA tensors every pass launches a kernel of ``ops/dp_cuda.py``; for
CPU tensors it runs the plain version in ``ops/dp_ref.py``.  Any other
device raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from deepblast_torch import native
from deepblast_torch.ops import dp_cuda, dp_ref

__all__ = [
    "alignment_score",
    "expected_alignment",
    "expected_alignment_stream",
    "stream_cell",
    "traceback",
    "traceback_stream",
]


def _passes(t):
    """The kernels (CUDA tensor) or their plain versions (CPU tensor)."""
    if t.device.type == "cuda":
        return dp_cuda
    if t.device.type == "cpu":
        return dp_ref
    raise ValueError(f"no DP implementation for device {t.device}")


def _lengths(theta, lengths):
    B, N, M = theta.shape
    if lengths is None:
        ln = torch.full((B,), N, dtype=torch.int32, device=theta.device)
        lm = torch.full((B,), M, dtype=torch.int32, device=theta.device)
        return ln, lm
    ln, lm = lengths
    return (torch.as_tensor(ln).to(theta.device, torch.int32).contiguous(),
            torch.as_tensor(lm).to(theta.device, torch.int32).contiguous())


def _check(theta, A):
    if theta.dim() != 3 or A.shape != theta.shape:
        raise ValueError(f"theta and A must both be (B, N, M), got "
                         f"{tuple(theta.shape)} and {tuple(A.shape)}")
    return theta.contiguous(), A.contiguous()


def _terminal_seed(theta, Et):
    if Et is None:
        return torch.ones((theta.shape[0],), dtype=theta.dtype,
                          device=theta.device)
    return torch.as_tensor(Et).to(theta.device, theta.dtype).contiguous()


class _Expected(torch.autograd.Function):
    """``(theta, A, Et) -> E`` (and ``E_A`` with ``return_gap``)."""

    @staticmethod
    def forward(ctx, theta, A, Et, ln, lm, mode, operator, return_gap):
        ops = _passes(theta)
        B, N, M = theta.shape
        kw = dict(mode=mode, operator=operator)
        _, dx, dm = ops.forward(ops.skew(theta), ops.skew(A), ln, lm, **kw)
        E_s, EA_s = ops.backward(dx, dm, ln, lm, Et, want_gap=return_gap,
                                 **kw)
        ctx.save_for_backward(dx, dm, E_s, ln, lm)
        ctx.cfg = (mode, operator, return_gap)
        ctx.set_materialize_grads(False)
        E = ops.unskew(E_s, N, M)
        return (E, ops.unskew(EA_s, N, M)) if return_gap else E

    @staticmethod
    @once_differentiable
    def backward(ctx, Zt, Za=None):
        dx, dm, E_s, ln, lm = ctx.saved_tensors
        mode, operator, return_gap = ctx.cfg
        ops = _passes(dx)
        B, K, S = dx.shape
        N, M = S - 1, K - S + 2
        # cotangents are unbounded: they go through the float skew
        if Zt is None:
            zt_s = dx.new_zeros((B, K, S))
        else:
            zt_s = ops.skew(Zt.to(dx.dtype).contiguous())
        # no gap cotangent (the training decode path): the adjoint forward
        # drops the Za stream instead of streaming zeros
        za_s = None if (not return_gap or Za is None) else \
            ops.skew(Za.to(dx.dtype).contiguous())
        kw = dict(mode=mode, operator=operator)
        vtd, dxd, dmd = ops.adjoint_forward(dx, dm, zt_s, za_s, ln, lm, **kw)
        Ed_s, EdA_s = ops.adjoint_backward(dx, dm, dxd, dmd, E_s, ln, lm,
                                           **kw)
        # E is linear in Et, so d<cts, E>/dEt = <cts, E>/Et = vtd (the
        # adjoint forward's terminal tangent does not involve Et)
        return (ops.unskew(Ed_s, N, M), ops.unskew(EdA_s, N, M), vtd,
                None, None, None, None, None)


class _Score(torch.autograd.Function):
    """``(theta, A) -> Vt``; the gradient is :class:`_Expected` itself."""

    @staticmethod
    def forward(ctx, theta, A, ln, lm, mode, operator):
        ops = _passes(theta)
        ctx.save_for_backward(theta, A, ln, lm)
        ctx.cfg = (mode, operator)
        return ops.forward_score(ops.skew(theta), ops.skew(A), ln, lm,
                                 mode=mode, operator=operator)

    @staticmethod
    def backward(ctx, gVt):
        theta, A, ln, lm = ctx.saved_tensors
        mode, operator = ctx.cfg
        g_theta, g_A = _Expected.apply(theta, A, gVt.contiguous(), ln, lm,
                                       mode, operator, True)
        return g_theta, g_A, None, None, None, None


def alignment_score(theta, A, lengths=None, *, mode="nw",
                    operator="softmax"):
    """Terminal smoothed alignment score ``Vt (B,)`` of a padded batch,
    differentiable twice in ``theta`` and ``A``.

    ``theta``/``A``: ``(B, N, M)`` match and per-cell gap potentials;
    ``lengths``: optional ``(ln, lm)`` true lengths (default: full)."""
    theta, A = _check(theta, A)
    ln, lm = _lengths(theta, lengths)
    return _Score.apply(theta, A, ln, lm, mode, operator)


def expected_alignment(theta, A, lengths=None, Et=None, *, mode="nw",
                       operator="softmax", return_gap=False):
    """Expected (posterior marginal) alignment ``E (B, N, M)`` — the
    gradient of :func:`alignment_score` scaled by ``Et`` (default ones) —
    differentiable in ``theta``, ``A`` and ``Et``.  With ``return_gap``
    also the expected gap-potential usage ``E_A = dVt/dA``: returns
    ``(E, E_A)``."""
    theta, A = _check(theta, A)
    ln, lm = _lengths(theta, lengths)
    Et = _terminal_seed(theta, Et)
    return _Expected.apply(theta, A, Et, ln, lm, mode, operator,
                           bool(return_gap))


def expected_alignment_stream(theta, A, lengths=None, Et=None, *, mode="nw",
                              operator="softmax"):
    """Expected alignment (posterior marginals) as a ``(B, K, S)`` stream:
    skew, forward with residuals, backward.  Inference only.  Cell
    ``(i, j)`` of pair ``b`` is :func:`stream_cell` ``(E, b, i, j)``;
    :func:`traceback_stream` walks it without a relayout."""
    theta, A = _check(theta, A)
    ops = _passes(theta)
    ln, lm = _lengths(theta, lengths)
    Et = _terminal_seed(theta, Et)
    _, dx, dm = ops.forward(ops.skew(theta), ops.skew(A), ln, lm,
                            mode=mode, operator=operator)
    return ops.backward(dx, dm, ln, lm, Et, mode=mode, operator=operator)[0]


def stream_cell(stream, b, i, j):
    """Cell ``(i, j)`` of pair ``b`` in a ``(B, K, S)`` stream."""
    return stream[b, i + j, i + 1]


# ---------------------------------------------------------------------------
# Traceback (host-side greedy walk)
# ---------------------------------------------------------------------------

def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x)


def traceback(grad):
    """Greedy argmax walk over one pair's expected-alignment matrix
    ``(n, m)`` (already cut to the true lengths).  Returns
    ``[(i, j, state), ...]`` with states (x, m, y) = (0, 1, 2), tie order
    (left, diag, up) and trailing-gap padding as the reference walk.

    Documented deviation kept from the JAX package: the diagonal move is
    disabled when *either* index is at the border (the reference's guard
    ``i <= 0 and j <= 0`` reads ``grad[-1, j-1]`` at ``i == 0``)."""
    grad = _host(grad)
    n, m = grad.shape
    return native.traceback_affine(grad.reshape(-1), m, 1, n, m)


def _traceback_walk(get, N, M):
    """The greedy walk over a cell accessor ``get(i, j)`` in Python — the
    oracle the C walk is tested against."""
    m, x, y = 1, 0, 2
    i, j = N - 1, M - 1
    states = [(i, j, m)]
    neg = -100000.0
    while True:
        left = neg if i <= 0 else get(i - 1, j)
        diag = neg if (i <= 0 or j <= 0) else get(i - 1, j - 1)
        upper = neg if j <= 0 else get(i, j - 1)
        if left == neg and diag == neg and upper == neg:
            break
        ij = int(np.argmax([left, diag, upper]))
        if ij == 0:
            i, s = i - 1, x
        elif ij == 1:
            i, j, s = i - 1, j - 1, m
        else:
            j, s = j - 1, y
        states.append((i, j, s))
    while i > 0:
        i -= 1
        states.append((i, j, x))
    while j > 0:
        j -= 1
        states.append((i, j, y))
    return states[::-1]


def traceback_stream(stream, n, m, b=0):
    """Greedy traceback of pair ``b`` (true lengths ``(n, m)``) straight
    from a ``(B, K, S)`` expected-alignment stream.  Pair ``b``'s cell
    ``(i, j)`` has the flat offset ``b*K*S + 1 + i*(S+1) + j*S``, so the C
    walk reads the stream in place.  A CUDA stream is copied to the host
    whole: for many pairs, copy once and pass the numpy array."""
    s = _host(stream)
    B, K, S = s.shape
    N, M = S - 1, K - S + 2
    if not (0 <= b < B and 1 <= n <= N and 1 <= m <= M):
        raise ValueError(f"pair {b} with lengths ({n}, {m}) is outside a "
                         f"stream of {B} pairs padded to ({N}, {M})")
    flat = s.reshape(-1)[b * K * S + 1:]
    return native.traceback_affine(flat, S + 1, S, n, m)
