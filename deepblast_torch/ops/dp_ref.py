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
With ``want_gap`` the backward also returns ``EA[r] = E[r] (Qx[r] + Qy[r])``,
the expected gap-potential usage ``dVt/dA`` (``deepblast_tpu/ops/dp.py:87-95``).

The training passes are the JVP of the forward and of the backward along
the cotangents ``(Zt, Za)`` (the expected alignment's VJP by Hessian
symmetry, ``deepblast_tpu/ops/dp.py:232-271``), after the batch-minor
training kernels ``_afwd_train_kernel`` / ``_abwd_train_kernel``
(``deepblast_tpu/ops/dp_bm_train.py:381``/``:512``) with the boundaries of
``dp_scan.adjoint_forward_scan`` / ``adjoint_backward_scan`` (``:191-283``).

Adjoint forward, rows ascending, ``Q[r]`` recomputed from ``(Dx, Dm)``::

    Dxd = shr(Vd[r-1]) - Vd[r-1]
    Dmd = shr(Vd[r-2]) - Za[r] - Vd[r-1]        (no Za term when Za is None)
    Vd[r] = Zt[r] + Za[r] + Vd[r-1] + Qx Dxd + Qm Dmd          masked

(``Q`` sums to one, so the tangent of ``max3`` telescopes to the
differences), and ``vtd`` is ``Vd`` at the terminal cell.  Adjoint
backward, rows descending, with ``Qd[r] = hessian3(Q[r], (Dxd, Dmd, 0))``::

    Ed[r] = shl(Qdx[r+1] E[r+1] + Qx[r+1] Ed[r+1])
          + shl(Qdm[r+2] E[r+2] + Qm[r+2] Ed[r+2])
          + Qdy[r+1] E[r+1] + Qy[r+1] Ed[r+1]                  masked
    EdA[r] = Ed[r] (Qx[r] + Qy[r]) + E[r] (Qdx[r] + Qdy[r])

The terminal seed has zero tangent, so ``Ed`` has no seed.  Dxd and Dmd are
written for every slot, so the unmasked ``Qd`` stays finite and, like
``Q``, only ever multiplies a zero ``E``/``Ed`` outside the band.

The Q-stream passes (``forward_q``, ``backward_q``, ``adjoint_forward_q``,
``adjoint_backward_q``) are those of the long-sequence backends
``pallas`` / ``pallas_long``: ``deepblast_tpu/ops/dp_pallas.py``
``forward_pallas`` (``_fwd_kernel`` ``:197-217``), ``backward_pallas``
(``_bwd_kernel`` ``:301-318``, with ``_backward_v2``'s gap product
``:595-600``), ``adjoint_forward_pallas`` (``_adj_fwd_kernel``
``:392-417``) and ``adjoint_backward_pallas`` (``_adj_bwd_kernel``
``:510-533``, with ``_adjoint_backward_v2``'s ``EdA`` ``:603-609``), in
their operation order.  The forward stores the three soft-argmax streams
``Q`` instead of the differences, in the direct form::

    (val, Q[r]) = max3(A[r] + shr(V[r-1]), shr(V[r-2]), A[r] + V[r-1])
    V[r] = theta[r] + val                                      masked

the backward reads ``Q`` back instead of recomputing it, the adjoint
forward stores ``Qd = hessian3(Q, args_d)`` along the tangent arguments
``(Za + shr(Vd[r-1]), shr(Vd[r-2]), Za + Vd[r-1])`` with
``Vd[r] = Zt[r] + Qx xd + Qm md + Qy yd``, and the adjoint backward reads
both.  Rows past ``K - 1`` read as zero (the TPU kernels' zero carries).
The ``scan`` backend (``ops/dp.py``) runs the same four passes on every
device, in the input type (float64 included), with ``residual_dtype`` as
its one storage knob: the scan oracle's recursions
(``deepblast_tpu/ops/dp_scan.py:83-283``) are these, with Q and Qd masked
to the valid band, which changes nothing they feed (E and Ed are zero
outside it).

Storage (``dtypes=``, a :class:`~deepblast_torch.ops.menu.DTypeMenu`) of
the default backend's passes, with the semantics of their JAX
counterparts: the forward dequantizes int16 input streams on load
(``stream_range / 32767``) and rounds Dx, Dm to ``d`` at the store
(``dp_bm.py:423-445``, ``:509-536``), while its value recurrence runs on
the unrounded differences; the backward reads D and stores E (and EA) in
``e``, except that an int16 ``e`` is stored in the compute type unless
``decode=True`` (the decode's E, ``dp_bm.py:628``, ``:1037-1043``); the
adjoint forward rounds Dxd, Dmd to ``d`` (``:709-716``); the adjoint
backward reads D, Dd and E and stores Ed, EdA like the training E
(``:837``).  Compute is float32, or the input type where that is wider
(``menu.compute_dtype``, from theta's stream in the forward, ``Et`` in the
backward, ``Zt``'s stream in the adjoint forward and ``E`` in the adjoint
backward, as ``dp_bm._cdt``).  The Q-stream passes take no menu: the JAX
package registers none for them (``dp_pallas.py:646-680``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepblast_torch.ops import smooth
from deepblast_torch.ops.menu import (E_SCALE, I16_MAX, as_menu,
                                      compute_dtype, dequantize, quantize)
from deepblast_torch.ops.skew import skew, skew_pair, unskew

__all__ = ["MODE_BOUNDS", "skew", "skew_pair", "unskew", "forward", "forward_score",
           "backward", "adjoint_forward", "adjoint_backward", "forward_q",
           "backward_q", "adjoint_forward_q", "adjoint_backward_q"]

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


def _load(x, cdt, stream_range):
    """A stored stream row in the compute type: int16 fixed point
    dequantized by ``stream_range / 32767`` (``dp_bm._deq``)."""
    if x.dtype == torch.int16:
        return dequantize(x, stream_range / I16_MAX, cdt)
    return x.to(cdt)


def _e_store(E, r, e, decode):
    """Store row ``r`` of an expectation stream: int16 fixed point at scale
    32767 only in the decode (``dp_bm._eq``)."""
    E[:, r] = quantize(e, E_SCALE) if (decode and E.dtype == torch.int16) \
        else e


def _e_dtype(menu, cdt, decode):
    """Storage of the expectation streams: ``e``, but the compute type for
    an int16 ``e`` outside the decode (training E, Ed, EdA are unbounded)."""
    edt = menu.e_dtype
    if edt is None or (edt == torch.int16 and not decode):
        return cdt
    return edt


def _forward(th_s, A_s, ln, lm, mode, operator, store, dtypes):
    menu = as_menu(dtypes)
    B, K, S = th_s.shape
    lo = MODE_BOUNDS[mode][0]
    cdt = compute_dtype(th_s.dtype)
    rng = menu.stream_range
    slots = torch.arange(S, device=th_s.device)
    zero = torch.zeros((), dtype=cdt, device=th_s.device)
    v1 = th_s.new_zeros((B, S), dtype=cdt)
    v2 = v1
    vt = th_s.new_zeros((B,), dtype=cdt)
    ddt = menu.d_dtype or cdt
    dxs = th_s.new_empty(th_s.shape, dtype=ddt) if store else None
    dms = th_s.new_empty(th_s.shape, dtype=ddt) if store else None
    for r in range(K):
        a = _load(A_s[:, r], cdt, rng)
        dx = _shr(v1) - v1
        dm = _shr(v2) - a - v1
        if store:
            dxs[:, r] = dx
            dms[:, r] = dm
        rel, _ = smooth.max3(operator, dx, dm, torch.zeros_like(dx))
        v = _load(th_s[:, r], cdt, rng) + a + v1 + rel
        valid, term = _masks(slots, r + 2, ln, lm, lo)
        v = torch.where(valid, v, zero)
        vt = vt + torch.where(term, v, zero).sum(1)
        v2, v1 = v1, v
    return vt, dxs, dms


def forward(th_s, A_s, ln, lm, *, mode="nw", operator="softmax",
            dtypes=None):
    """Forward pass storing the residuals: ``(vt (B,), Dx, Dm (B, K, S))``,
    Dx and Dm in the menu's ``d``.  Plain version of the ``forward``
    kernel."""
    return _forward(th_s, A_s, ln, lm, mode, operator, True, dtypes)


def forward_score(th_s, A_s, ln, lm, *, mode="nw", operator="softmax",
                  dtypes=None):
    """Terminal scores ``vt (B,)`` only.  Plain version of the
    ``forward_score`` kernel."""
    return _forward(th_s, A_s, ln, lm, mode, operator, False, dtypes)[0]


def backward(dxs, dms, ln, lm, Et, *, mode="nw", operator="softmax",
             want_gap=False, dtypes=None, decode=False):
    """Expected alignment ``E (B, K, S)`` from the forward residuals,
    seeded with ``Et (B,)`` at each pair's terminal cell, and with
    ``want_gap`` the gap expectation ``EA = E (Qx + Qy)`` (else None).
    Returns ``(E, EA)`` in the menu's ``e`` (int16 only with ``decode``,
    which assumes ``Et`` in ``[0, 1]``).  Plain version of the
    ``backward`` kernel."""
    menu = as_menu(dtypes)
    B, K, S = dxs.shape
    lo = MODE_BOUNDS[mode][1]
    cdt = compute_dtype(Et.dtype)
    slots = torch.arange(S, device=dxs.device)
    zero = torch.zeros((), dtype=cdt, device=dxs.device)
    Et = Et[:, None]
    z = dxs.new_zeros((B, S), dtype=cdt)
    e1 = e2 = z
    qx1 = qm1 = qy1 = qm2 = z
    edt = _e_dtype(menu, cdt, decode)
    E = dxs.new_empty(dxs.shape, dtype=edt)
    EA = dxs.new_empty(dxs.shape, dtype=edt) if want_gap else None
    for r in reversed(range(K)):
        e = _shl(qx1 * e1) + _shl(qm2 * e2) + qy1 * e1
        valid, term = _masks(slots, r + 2, ln, lm, lo)
        e = torch.where(valid, e, zero)
        e = e + torch.where(term, Et, zero)
        _e_store(E, r, e, decode)
        _, (qx, qm, qy) = smooth.max3(operator, dxs[:, r].to(cdt),
                                      dms[:, r].to(cdt), torch.zeros_like(e))
        if want_gap:
            _e_store(EA, r, e * (qx + qy), decode)
        e2, e1 = e1, e
        qm2 = qm1
        qx1, qm1, qy1 = qx, qm, qy
    return E, EA


def adjoint_forward(dxs, dms, zt_s, za_s, ln, lm, *, mode="nw",
                    operator="softmax", dtypes=None):
    """Tangent of the forward along the skewed cotangents ``zt_s`` and
    ``za_s`` (``None``: a zero gap cotangent, no Za term at all).  Returns
    ``(vtd (B,), Dxd, Dmd (B, K, S))``, Dxd and Dmd in the menu's ``d``.
    Plain version of the ``adjoint_forward`` kernel."""
    menu = as_menu(dtypes)
    B, K, S = dxs.shape
    lo = MODE_BOUNDS[mode][2]
    cdt = compute_dtype(zt_s.dtype)
    rng = menu.stream_range
    slots = torch.arange(S, device=dxs.device)
    zero = torch.zeros((), dtype=cdt, device=dxs.device)
    vd1 = dxs.new_zeros((B, S), dtype=cdt)
    vd2 = vd1
    vtd = dxs.new_zeros((B,), dtype=cdt)
    ddt = menu.d_dtype or cdt
    dxds = dxs.new_empty(dxs.shape, dtype=ddt)
    dmds = dxs.new_empty(dxs.shape, dtype=ddt)
    for r in range(K):
        _, (qx, qm, _) = smooth.max3(operator, dxs[:, r].to(cdt),
                                     dms[:, r].to(cdt), torch.zeros_like(vd1))
        dxd = _shr(vd1) - vd1
        zt = _load(zt_s[:, r], cdt, rng)
        if za_s is None:
            dmd = _shr(vd2) - vd1
            vd = zt + vd1 + qx * dxd + qm * dmd
        else:
            za = _load(za_s[:, r], cdt, rng)
            dmd = _shr(vd2) - za - vd1
            vd = zt + za + vd1 + qx * dxd + qm * dmd
        dxds[:, r] = dxd
        dmds[:, r] = dmd
        valid, term = _masks(slots, r + 2, ln, lm, lo)
        vd = torch.where(valid, vd, zero)
        vtd = vtd + torch.where(term, vd, zero).sum(1)
        vd2, vd1 = vd1, vd
    return vtd, dxds, dmds


def adjoint_backward(dxs, dms, dxds, dmds, E, ln, lm, *, mode="nw",
                     operator="softmax", dtypes=None):
    """Tangent of the backward: ``(Ed, EdA)``, both ``(B, K, S)``, from the
    forward residuals, the adjoint forward's ``Dxd``/``Dmd`` and the
    backward's ``E``, stored like the training E (the menu's ``e``, the
    compute type for int16).  Plain version of the ``adjoint_backward``
    kernel."""
    menu = as_menu(dtypes)
    B, K, S = dxs.shape
    lo = MODE_BOUNDS[mode][3]
    cdt = compute_dtype(E.dtype)
    slots = torch.arange(S, device=dxs.device)
    zero = torch.zeros((), dtype=cdt, device=dxs.device)
    z = dxs.new_zeros((B, S), dtype=cdt)
    ed1 = ed2 = e1 = e2 = z
    qx1 = qm1 = qy1 = qm2 = z
    qdx1 = qdm1 = qdy1 = qdm2 = z
    edt = _e_dtype(menu, cdt, False)
    Ed = dxs.new_empty(dxs.shape, dtype=edt)
    EdA = dxs.new_empty(dxs.shape, dtype=edt)
    for r in reversed(range(K)):
        ed = (_shl(qdx1 * e1 + qx1 * ed1) + _shl(qdm2 * e2 + qm2 * ed2)
              + qdy1 * e1 + qy1 * ed1)
        valid, _ = _masks(slots, r + 2, ln, lm, lo)
        ed = torch.where(valid, ed, zero)
        Ed[:, r] = ed
        q = smooth.max3(operator, dxs[:, r].to(cdt), dms[:, r].to(cdt),
                        torch.zeros_like(ed))[1]
        qd = smooth.hessian3(operator, q,
                             (dxds[:, r].to(cdt), dmds[:, r].to(cdt),
                              torch.zeros_like(ed)))
        e = E[:, r].to(cdt)
        EdA[:, r] = ed * (q[0] + q[2]) + e * (qd[0] + qd[2])
        ed2, ed1 = ed1, ed
        e2, e1 = e1, e
        qm2, qdm2 = qm1, qdm1
        (qx1, qm1, qy1), (qdx1, qdm1, qdy1) = q, qd
    return Ed, EdA


# ---------------------------------------------------------------------------
# Q-stream passes (the pallas / pallas_long backends)
# ---------------------------------------------------------------------------

def _row(x, r, z):
    """Row ``r`` of a ``(B, K, S)`` stream; zeros past its last row."""
    return x[:, r] if r < x.shape[1] else z


def _widen(*qs):
    """Q streams in the compute type: a bfloat16 store widens exactly to
    float32, as the TPU reverse passes read them (``dp_pallas.py:296-310``,
    ``:396-398``, ``:499-502``); float64 stays float64."""
    return tuple(q.to(compute_dtype(q.dtype)) for q in qs)


def _rounded(x, residual_dtype):
    """``x`` rounded through ``residual_dtype`` and back (``astype(rd)
    .astype(dtype)``, ``dp_scan.py:130-132``); float64 reaches bfloat16
    through float32, as XLA's convert does."""
    return x.to(torch.float32).to(residual_dtype).to(x.dtype)


def forward_q(th_s, A_s, ln, lm, *, mode="nw", operator="softmax",
              q_dtype=None, residual_dtype=None):
    """Forward storing the soft-argmax streams: ``(vt (B,), Qx, Qm, Qy
    (B, K, S))``, Q written for every slot, in ``q_dtype`` (None: the
    input's type; ``torch.bfloat16`` rounds each store to nearest even,
    as ``dp_pallas.forward_pallas`` under ``Q_DTYPE``, ``:212-214``).
    Plain version of the ``forward_q`` kernel.

    With ``residual_dtype`` (the scan backend's ``d`` menu,
    ``dp_scan.forward_scan``, ``:127-134``) each stored Q is rebuilt as
    ``softargmax(Dx, Dm, 0)`` from the argument differences
    ``Dx = xarg - yarg`` and ``Dm = marg - yarg`` rounded through that
    type; the value recursion keeps the unrounded arguments."""
    B, K, S = th_s.shape
    lo = MODE_BOUNDS[mode][0]
    slots = torch.arange(S, device=th_s.device)
    zero = th_s.new_zeros(())
    v1 = th_s.new_zeros((B, S))
    v2 = v1
    vt = th_s.new_zeros((B,))
    qx, qm, qy = (torch.empty_like(th_s, dtype=q_dtype) for _ in range(3))
    for r in range(K):
        a = A_s[:, r]
        xarg, marg, yarg = a + _shr(v1), _shr(v2), a + v1
        val, (px, pm, py) = smooth.max3(operator, xarg, marg, yarg)
        if residual_dtype is not None:
            dx = _rounded(xarg - yarg, residual_dtype)
            dm = _rounded(marg - yarg, residual_dtype)
            _, (px, pm, py) = smooth.max3(operator, dx, dm,
                                          torch.zeros_like(dx))
        qx[:, r], qm[:, r], qy[:, r] = px, pm, py
        v = th_s[:, r] + val
        valid, term = _masks(slots, r + 2, ln, lm, lo)
        v = torch.where(valid, v, zero)
        vt = vt + torch.where(term, v, zero).sum(1)
        v2, v1 = v1, v
    return vt, qx, qm, qy


def backward_q(qx, qm, qy, ln, lm, Et, *, mode="nw", want_gap=False):
    """Expected alignment ``E (B, K, S)`` from the stored Q streams, seeded
    with ``Et (B,)``, and with ``want_gap`` ``EA = E (Qx + Qy)`` (else
    None).  Returns ``(E, EA)`` in the compute type of the Q streams
    (float32 for float32 or bfloat16 ones).  Plain version of the
    ``backward_q`` kernel."""
    qx, qm, qy = _widen(qx, qm, qy)
    B, K, S = qx.shape
    lo = MODE_BOUNDS[mode][1]
    slots = torch.arange(S, device=qx.device)
    zero = qx.new_zeros(())
    Et = Et.to(qx.dtype)[:, None]
    z = qx.new_zeros((B, S))
    e1 = e2 = z
    E = torch.empty_like(qx)
    EA = torch.empty_like(qx) if want_gap else None
    for r in reversed(range(K)):
        e = (_shl(_row(qx, r + 1, z) * e1) + _shl(_row(qm, r + 2, z) * e2)
             + _row(qy, r + 1, z) * e1)
        valid, term = _masks(slots, r + 2, ln, lm, lo)
        e = torch.where(valid, e, zero)
        e = e + torch.where(term, Et, zero)
        E[:, r] = e
        if want_gap:
            EA[:, r] = e * (qx[:, r] + qy[:, r])
        e2, e1 = e1, e
    return E, EA


def adjoint_forward_q(qx, qm, qy, zt_s, za_s, ln, lm, *, mode="nw",
                      operator="softmax", residual_dtype=None):
    """Tangent of the Q forward along the skewed cotangents ``zt_s`` and
    ``za_s`` (``None``: a zero gap cotangent, no Za term).  Returns
    ``(vtd (B,), Qdx, Qdm, Qdy (B, K, S))`` in the compute type of the Q
    streams.  Plain version of the ``adjoint_forward_q`` kernel.

    With ``residual_dtype`` (``dp_scan.adjoint_forward_scan``,
    ``:223-229``) ``Qd`` is the Hessian product along the tangent
    differences ``(xd - yd, md - yd, 0)`` rounded through that type."""
    qx, qm, qy = _widen(qx, qm, qy)
    B, K, S = qx.shape
    lo = MODE_BOUNDS[mode][2]
    slots = torch.arange(S, device=qx.device)
    zero = qx.new_zeros(())
    vd1 = qx.new_zeros((B, S))
    vd2 = vd1
    vtd = qx.new_zeros((B,))
    qdx, qdm, qdy = (torch.empty_like(qx) for _ in range(3))
    for r in range(K):
        q = (qx[:, r], qm[:, r], qy[:, r])
        if za_s is None:
            xd, yd = _shr(vd1), vd1
        else:
            za = za_s[:, r]
            xd, yd = za + _shr(vd1), za + vd1
        md = _shr(vd2)
        vd = zt_s[:, r] + q[0] * xd + q[1] * md + q[2] * yd
        if residual_dtype is None:
            hargs = (xd, md, yd)
        else:
            dxd = _rounded(xd - yd, residual_dtype)
            hargs = (dxd, _rounded(md - yd, residual_dtype),
                     torch.zeros_like(dxd))
        qdx[:, r], qdm[:, r], qdy[:, r] = smooth.hessian3(operator, q, hargs)
        valid, term = _masks(slots, r + 2, ln, lm, lo)
        vd = torch.where(valid, vd, zero)
        vtd = vtd + torch.where(term, vd, zero).sum(1)
        vd2, vd1 = vd1, vd
    return vtd, qdx, qdm, qdy


def adjoint_backward_q(qx, qm, qy, qdx, qdm, qdy, E, ln, lm, *, mode="nw"):
    """Tangent of the Q backward: ``(Ed, EdA)``, both ``(B, K, S)``, from
    the Q and Qd streams and the backward's ``E``, with
    ``EdA = Ed (Qx + Qy) + E (Qdx + Qdy)``, in the compute type of the Q
    streams.  Plain version of the ``adjoint_backward_q`` kernel."""
    qx, qm, qy = _widen(qx, qm, qy)
    B, K, S = qx.shape
    lo = MODE_BOUNDS[mode][3]
    slots = torch.arange(S, device=qx.device)
    zero = qx.new_zeros(())
    z = qx.new_zeros((B, S))
    ed1 = ed2 = e1 = e2 = z
    Ed = torch.empty_like(qx)
    EdA = torch.empty_like(qx)
    for r in reversed(range(K)):
        ed = (_shl(_row(qdx, r + 1, z) * e1 + _row(qx, r + 1, z) * ed1)
              + _shl(_row(qdm, r + 2, z) * e2 + _row(qm, r + 2, z) * ed2)
              + _row(qdy, r + 1, z) * e1 + _row(qy, r + 1, z) * ed1)
        valid, _ = _masks(slots, r + 2, ln, lm, lo)
        ed = torch.where(valid, ed, zero)
        Ed[:, r] = ed
        e = E[:, r]
        EdA[:, r] = ed * (qx[:, r] + qy[:, r]) + e * (qdx[:, r] + qdy[:, r])
        ed2, ed1 = ed1, ed
        e2, e1 = e1, e
    return Ed, EdA
