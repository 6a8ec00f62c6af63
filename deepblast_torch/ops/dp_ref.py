"""Plain PyTorch versions of the DP kernels, on the port's stream layout.

One function per CUDA kernel in ``deepblast_torch/csrc/dp_kernels.cu``,
with the kernel's signature (``ops/dp_cuda.py``).  They are what the
dispatcher (``ops/dp.py``) runs for tensors on the CPU, what the CPU tests
hold against the JAX package, and what ``chip_smoke.py`` holds each kernel
against on the card.

The recurrences are those of the batch-minor TPU kernels
(``deepblast_tpu/ops/dp_bm.py``: ``_fwd_phase_kernel`` / ``_fwd_score_kernel``
``:932``/``:468``, ``_bwd_phase_kernel`` ``:976``), with the boundary
semantics of the scan oracle (``deepblast_tpu/ops/dp_scan.py:83-190``):
``MODE_BOUNDS`` for the lower loop bound, the length masks of
``dp_bm._masks`` and the terminal seeding at cell ``(ln, lm)``.

Forward, per diagonal row ``r`` (``k = r + 2``), on ``(B, S)`` planes::

    Dx = shr(V[r-1]) - V[r-1]              (xarg - yarg; A cancels)
    Dm = shr(V[r-2]) - A[r] - V[r-1]       (marg - yarg)
    V[r] = theta[r] + A[r] + V[r-1] + max3(Dx, Dm, 0)     masked by `valid`

Backward, rows descending, with ``Q[r] = softargmax(Dx[r], Dm[r], 0)``::

    E[r] = shl(Qx[r+1] E[r+1]) + shl(Qm[r+2] E[r+2]) + Qy[r+1] E[r+1]

masked by `valid`, plus ``Et`` at the terminal cell.  Dx and Dm are kept
for every slot (finite everywhere), Q is recomputed unmasked, and E is
zero outside the valid band, so Q outside the band only ever multiplies 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepblast_torch.ops import smooth
from deepblast_torch.ops.skew import skew

__all__ = ["MODE_BOUNDS", "skew", "forward", "forward_score", "backward"]

# Lower loop bounds per pass (forward, backward, adjoint_fwd, adjoint_bwd),
# as deepblast_tpu/ops/dp_scan.py:55-58.
MODE_BOUNDS = {
    "nw": (1, 1, 1, 1),
    "sw": (2, 2, 2, 2),
}


def _shr(v):
    """out[:, s] = v[:, s-1]; out[:, 0] = 0."""
    return F.pad(v[:, :-1], (1, 0))


def _shl(v):
    """out[:, s] = v[:, s+1]; out[:, -1] = 0."""
    return F.pad(v[:, 1:], (0, 1))


def _masks(slots, k, ln, lm, lo):
    i = slots[None, :]
    j = k - i
    valid = ((i >= lo) & (j >= lo)
             & (i <= ln[:, None]) & (j <= lm[:, None]))
    term = (i == ln[:, None]) & (k == (ln + lm))[:, None]
    return valid, term


def _forward(th_s, A_s, ln, lm, mode, operator, store):
    B, K, S = th_s.shape
    lo = MODE_BOUNDS[mode][0]
    slots = torch.arange(S, device=th_s.device)
    zero = th_s.new_zeros(())
    v1 = th_s.new_zeros((B, S))
    v2 = v1
    vt = th_s.new_zeros((B,))
    dxs = torch.empty_like(th_s) if store else None
    dms = torch.empty_like(th_s) if store else None
    for r in range(K):
        a = A_s[:, r]
        dx = _shr(v1) - v1
        dm = _shr(v2) - a - v1
        if store:
            dxs[:, r] = dx
            dms[:, r] = dm
        rel, _ = smooth.max3(operator, dx, dm, torch.zeros_like(dx))
        v = th_s[:, r] + a + v1 + rel
        valid, term = _masks(slots, r + 2, ln, lm, lo)
        v = torch.where(valid, v, zero)
        vt = vt + torch.where(term, v, zero).sum(1)
        v2, v1 = v1, v
    return vt, dxs, dms


def forward(th_s, A_s, ln, lm, *, mode="nw", operator="softmax"):
    """Forward pass storing the residuals: ``(vt (B,), Dx, Dm (B, K, S))``.
    Plain version of the ``forward`` kernel."""
    return _forward(th_s, A_s, ln, lm, mode, operator, True)


def forward_score(th_s, A_s, ln, lm, *, mode="nw", operator="softmax"):
    """Terminal scores ``vt (B,)`` only.  Plain version of the
    ``forward_score`` kernel."""
    return _forward(th_s, A_s, ln, lm, mode, operator, False)[0]


def backward(dxs, dms, ln, lm, Et, *, mode="nw", operator="softmax"):
    """Expected alignment ``E (B, K, S)`` from the forward residuals,
    seeded with ``Et (B,)`` at each pair's terminal cell.  Plain version of
    the ``backward`` kernel."""
    B, K, S = dxs.shape
    lo = MODE_BOUNDS[mode][1]
    slots = torch.arange(S, device=dxs.device)
    zero = dxs.new_zeros(())
    Et = Et.to(dxs.dtype)[:, None]
    z = dxs.new_zeros((B, S))
    e1 = e2 = z
    qx1 = qm1 = qy1 = qm2 = z
    E = torch.empty_like(dxs)
    for r in reversed(range(K)):
        e = _shl(qx1 * e1) + _shl(qm2 * e2) + qy1 * e1
        valid, term = _masks(slots, r + 2, ln, lm, lo)
        e = torch.where(valid, e, zero)
        e = e + torch.where(term, Et, zero)
        E[:, r] = e
        _, (qx, qm, qy) = smooth.max3(operator, dxs[:, r], dms[:, r],
                                      torch.zeros_like(e))
        e2, e1 = e1, e
        qm2 = qm1
        qx1, qm1, qy1 = qx, qm, qy
    return E
