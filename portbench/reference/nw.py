"""The smoothed Needleman-Wunsch recursion of DeepBLAST (Morton et al.
2020; Mensch & Blondel 2018) and its expected alignment, as plain tensor
operations with autograd supplying every derivative.

For a pair with true lengths ``(n, m)``, ``V`` is ``(n+1) x (m+1)``,
zero on the first row and column, and for ``1 <= i <= n, 1 <= j <= m``::

    V[i, j] = theta[i-1, j-1] + logsumexp(A[i-1, j-1] + V[i-1, j],
                                          V[i-1, j-1],
                                          A[i-1, j-1] + V[i, j-1])

The alignment score is ``V[n, m]``; the expected alignment ``E`` is its
gradient with respect to ``theta``, and a loss of ``E`` differentiates
once more to ``theta`` and ``A`` (``create_graph``).  Cells past the
lengths hold zero and take no part.  The recursion runs over
anti-diagonals, vectorised over the batch and the cells of a diagonal.
"""

from __future__ import annotations

import torch

__all__ = ["score", "expected", "greedy_path", "path_gap"]


def _diagonals(x, N, M):
    """``x`` ``(B, N, M)`` laid out as ``B x K x (N+1)`` anti-diagonals
    (diagonal ``r`` holds cells with ``i + j = r + 2``, slot ``i``), zero
    off the matrix; one gather, so its gradient is one scatter."""
    K, S = N + M - 1, N + 1
    r = torch.arange(K, device=x.device)[:, None]
    i = torch.arange(S, device=x.device)[None, :]
    j = r + 2 - i
    inside = (i >= 1) & (i <= N) & (j >= 1) & (j <= M)
    flat = torch.where(inside, (i - 1) * M + (j - 1), 0).reshape(-1)
    out = x.reshape(x.shape[0], -1)[:, flat].view(x.shape[0], K, S)
    return torch.where(inside, out, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


def _shift(v):
    """``out[:, i] = v[:, i - 1]``, zero at slot 0."""
    return torch.nn.functional.pad(v[:, :-1], (1, 0))


def score(theta, A, x_len, y_len):
    """Alignment scores ``V[n, m]`` ``(B,)``."""
    B, N, M = theta.shape
    K, S = N + M - 1, N + 1
    th = _diagonals(theta, N, M).unbind(1)
    a = _diagonals(A, N, M).unbind(1)
    i = torch.arange(S, device=theta.device)[None, :]
    r = torch.arange(K, device=theta.device)[:, None, None]
    j = r + 2 - i
    valid = ((i >= 1) & (j >= 1) & (i <= x_len[:, None])
             & (j <= y_len[:, None])).unbind(0)
    zero = theta.new_zeros(())
    v1 = v2 = theta.new_zeros((B, S))
    rows = []
    for k in range(K):
        args = torch.stack([a[k] + _shift(v1), _shift(v2), a[k] + v1])
        v = torch.where(valid[k], th[k] + torch.logsumexp(args, 0), zero)
        rows.append(v)
        v2, v1 = v1, v
    V = torch.stack(rows, 1)
    b = torch.arange(B, device=theta.device)
    return V[b, (x_len + y_len - 2).long(), x_len.long()]


def expected(theta, A, x_len, y_len, create_graph=False):
    """Expected alignment ``E`` ``(B, N, M)`` (the gradient of the scores
    with respect to ``theta``); with ``create_graph`` it differentiates
    again to ``theta`` and ``A``."""
    if not theta.requires_grad:
        theta = theta.detach().requires_grad_(True)
    with torch.enable_grad():
        v = score(theta, A, x_len, y_len)
        E, = torch.autograd.grad(v.sum(), theta, create_graph=create_graph)
    return E


_NEG = float("-inf")


def _moves(E, i, j):
    """Values of the greedy walk's three moves from ``(i, j)``: to
    ``(i-1, j)``, ``(i-1, j-1)`` and ``(i, j-1)``, ``-inf`` off the
    matrix (the diagonal also on either border)."""
    return (E[i - 1, j] if i > 0 else _NEG,
            E[i - 1, j - 1] if i > 0 and j > 0 else _NEG,
            E[i, j - 1] if j > 0 else _NEG)


def greedy_path(E):
    """DeepBLAST's traceback of one pair's ``E`` ``(n, m)`` (a NumPy
    array): from ``(n-1, m-1)`` to ``(0, 0)``, each step to the largest of
    the three moves, ties to the first; as a TM-align state string
    (``1`` a move in x alone, ``:`` a diagonal move, ``2`` a move in y
    alone), first state first, ending in ``:``."""
    i, j = E.shape[0] - 1, E.shape[1] - 1
    out = [":"]
    while i > 0 or j > 0:
        vals = _moves(E, i, j)
        c = max(range(3), key=lambda t: (vals[t], -t))
        out.append("1:2"[c])
        i, j = i - (c < 2), j - (c > 0)
    return "".join(reversed(out))


def path_gap(E, states):
    """How far a served path strays from the greedy choice under ``E``
    ``(n, m)``: the largest, over its steps, of the best move's value less
    the value of the move taken; ``inf`` when the path takes a move off
    the matrix, has a state other than ``1 : 2``, or does not end at
    ``(0, 0)``."""
    i, j = E.shape[0] - 1, E.shape[1] - 1
    if not states or states[-1] != ":":
        return float("inf")
    gap = 0.0
    for s in reversed(states[:-1]):
        if s not in "1:2":
            return float("inf")
        c = "1:2".index(s)
        vals = _moves(E, i, j)
        if vals[c] == _NEG:
            return float("inf")
        gap = max(gap, float(max(vals) - vals[c]))
        i, j = i - (c < 2), j - (c > 0)
    return gap if (i, j) == (0, 0) else float("inf")
