"""The invariant the CUDA strip kernels rely on, on the CPU: evaluating
the smoothed max only on each diagonal's band gives the plain passes'
outputs bit for bit.

``band_forward`` and ``band_backward`` below restate ``ops/dp_ref.py``'s
forward and backward the way ``csrc/dp_kernels.cu`` computes them, one pair
at a time: ``max3`` runs only on the slots
``[max(lo, k - m), min(n, k - lo)]`` of diagonal ``k`` (and, in the
backward, the terminal slot, which is seeded with ``Et`` even where sw puts
it off the band); off it the forward's V is 0 and the backward's Q is 0;
the backward carries the products ``Qx E``, ``Qy E``, ``Qm E`` of the rows
before and sums ``E = shl(Qx1 E1) + shl(Qm2 E2) + Qy1 E1`` in the plain
order; rows past the terminal diagonal are a store loop (forward:
``Dx = 0 - 0``, ``Dm = (0 - A) - 0``; backward: zeros).

``band_adjoint_backward`` restates the adjoint backward's strip kernel: Q
and ``Qd = hessian3(Q, (Dxd, Dmd, 0))`` only on the band and wherever E is
non-zero off it (the terminal slot of sw with n = 1 or m = 1, or any E a
caller passes), every row walked; it carries the products
``X = Qdx E + Qx Ed``, ``M = Qdm E + Qm Ed``, ``Yd = Qdy E`` and
``Yq = Qy Ed`` of the rows before and sums
``Ed = shl(X1) + shl(M2) + Yd1 + Yq1`` in the plain order.  It is held to
the plain pass on an E from the plain backward (zero off the band) and on
an E that is noise at every slot.

``band_adjoint_forward`` restates the adjoint forward's strip kernel, the
forward's design run as a tangent: ``Q = max3(Dx, Dm, 0)`` and ``Vd`` only
on the band (``Vd = 0`` off it), ``Dxd = shr(Vd1) - Vd1`` and
``Dmd = shr(Vd2) [- Za] - Vd1`` stored at every slot, ``Vd = Zt [+ Za] +
Vd1 + Qx Dxd + Qm Dmd`` in the plain order, and a store loop past row
``n + m`` (``Dxd = 0 - 0``, ``Dmd = (0 - Za) - 0`` or ``0 - 0``).  It is
held to the plain pass with and without Za on the plain forward's Dx, Dm
and seeded cotangents.  Tolerance: none (``torch.equal``), since every
cell takes the same float32 operations.
"""

import numpy as np
import pytest
import torch

from deepblast_torch.ops import dp_ref, smooth
from deepblast_torch.ops.dp_ref import MODE_BOUNDS
from deepblast_torch.ops.skew import skew
import torch_threads  # noqa: F401  (PyTorch threads a worker)

SHAPES = [(3, 9, 7), (2, 23, 40), (3, 40, 11), (2, 1, 17), (2, 17, 1)]


def _problem(seed, B, N, M):
    rng = np.random.default_rng(seed)
    theta = torch.tensor(rng.standard_normal((B, N, M)), dtype=torch.float32)
    A = torch.tensor(rng.standard_normal((B, N, M)) - 1.0,
                     dtype=torch.float32)
    ln = rng.integers(1, N + 1, size=B)
    lm = rng.integers(1, M + 1, size=B)
    ln[0], lm[0] = N, M
    ln[-1] = max(1, N // 5)                       # whole rows of padding
    Et = torch.tensor(rng.standard_normal(B), dtype=torch.float32)
    i32 = dict(dtype=torch.int32)
    return (skew(theta), skew(A), torch.tensor(ln, **i32),
            torch.tensor(lm, **i32), Et)


def _band(S, k, n, m, lo):
    s = torch.arange(S)
    return (s >= max(lo, k - m)) & (s <= min(n, k - lo))


def _shr(v):
    return torch.cat([v.new_zeros(1), v[:-1]])


def _shl(v):
    return torch.cat([v[1:], v.new_zeros(1)])


def band_forward(th_s, A_s, ln, lm, mode, operator):
    B, K, S = th_s.shape
    lo = MODE_BOUNDS[mode][0]
    vt = torch.zeros(B)
    dxs, dms = torch.empty_like(th_s), torch.empty_like(th_s)
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        rows = min(K, n + m + 1)
        v1 = v2 = torch.zeros(S)
        for r in range(rows):
            a, t = A_s[b, r], th_s[b, r]
            dx = _shr(v1) - v1
            dm = _shr(v2) - a - v1
            dxs[b, r], dms[b, r] = dx, dm
            band = _band(S, r + 2, n, m, lo)
            v = torch.zeros(S)
            rel, _ = smooth.max3(operator, dx[band], dm[band],
                                 torch.zeros_like(dx[band]))
            v[band] = t[band] + a[band] + v1[band] + rel
            if r + 2 == n + m and bool(band[n]):
                vt[b] = v[n]
            v2, v1 = v1, v
        zero = torch.zeros(S)
        for r in range(rows, K):
            dxs[b, r] = zero - zero
            dms[b, r] = zero - A_s[b, r] - zero
    return vt, dxs, dms


def band_backward(dxs, dms, ln, lm, Et, mode, operator):
    B, K, S = dxs.shape
    lo = MODE_BOUNDS[mode][1]
    E, EA = torch.empty_like(dxs), torch.empty_like(dxs)
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        top = min(K, n + m - 1)
        E[b, top:] = 0.0
        EA[b, top:] = 0.0
        x1 = y1 = m1 = m2 = torch.zeros(S)
        for r in reversed(range(top)):
            k = r + 2
            band = _band(S, k, n, m, lo)
            e = _shl(x1) + _shl(m2) + y1
            e = torch.where(band, e, torch.zeros(()))
            if k == n + m:
                e[n] = e[n] + Et[b]
                band = band.clone()
                band[n] = True
            q = [torch.zeros(S) for _ in range(3)]
            zero = torch.zeros_like(dxs[b, r, band])
            _, qb = smooth.max3(operator, dxs[b, r, band], dms[b, r, band],
                                zero)
            for full, part in zip(q, qb):
                full[band] = part
            px, pm, py = q
            E[b, r], EA[b, r] = e, e * (px + py)
            x1, y1, m2, m1 = px * e, py * e, m1, pm * e
    return E, EA


@pytest.mark.parametrize("B,N,M", SHAPES)
@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("operator", ["softmax", "sparsemax", "hardmax"])
def test_band_only_passes_equal_plain(B, N, M, mode, operator):
    th_s, A_s, ln, lm, Et = _problem(B * N + M, B, N, M)
    kw = dict(mode=mode, operator=operator)
    want = dp_ref.forward(th_s, A_s, ln, lm, **kw)
    got = band_forward(th_s, A_s, ln, lm, mode, operator)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(dp_ref.forward_score(th_s, A_s, ln, lm, **kw), got[0])
    _, dxs, dms = want
    want_e = dp_ref.backward(dxs, dms, ln, lm, Et, want_gap=True, **kw)
    got_e = band_backward(dxs, dms, ln, lm, Et, mode, operator)
    for g, w in zip(got_e, want_e):
        assert torch.equal(g, w)


def band_adjoint_backward(dxs, dms, dxds, dmds, E, ln, lm, mode, operator):
    B, K, S = dxs.shape
    lo = MODE_BOUNDS[mode][3]
    zero = torch.zeros(())
    Ed, EdA = torch.empty_like(dxs), torch.empty_like(dxs)
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        x1 = m1 = m2 = yd1 = yq1 = torch.zeros(S)
        for r in reversed(range(K)):
            band = _band(S, r + 2, n, m, lo)
            e = E[b, r]
            ed = torch.where(band, _shl(x1) + _shl(m2) + yd1 + yq1, zero)
            need = band | (e != 0)
            q = [torch.zeros(S) for _ in range(3)]
            qd = [torch.zeros(S) for _ in range(3)]
            z = torch.zeros_like(dxs[b, r, need])
            _, qn = smooth.max3(operator, dxs[b, r, need], dms[b, r, need],
                                z)
            qdn = smooth.hessian3(operator, qn, (dxds[b, r, need],
                                                 dmds[b, r, need], z))
            for full, part in zip(q + qd, list(qn) + list(qdn)):
                full[need] = part
            (px, pm, py), (hx, hm, hy) = q, qd
            Ed[b, r] = ed
            EdA[b, r] = torch.where(need, ed * (px + py) + e * (hx + hy),
                                    zero)
            x1 = torch.where(need, hx * e + px * ed, zero)
            m2, m1 = m1, torch.where(need, hm * e + pm * ed, zero)
            yd1 = torch.where(need, hy * e, zero)
            yq1 = torch.where(need, py * ed, zero)
    return Ed, EdA


@pytest.mark.parametrize("B,N,M", SHAPES)
@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("operator", ["softmax", "sparsemax", "hardmax"])
def test_band_adjoint_backward_equals_plain(B, N, M, mode, operator):
    th_s, A_s, ln, lm, Et = _problem(B * N + M + 1, B, N, M)
    rng = np.random.default_rng(B + N + M)
    zt_s = skew(torch.tensor(rng.standard_normal((B, N, M)),
                             dtype=torch.float32))
    noise = torch.tensor(rng.standard_normal(th_s.shape), dtype=torch.float32)
    kw = dict(mode=mode, operator=operator)
    _, dxs, dms = dp_ref.forward(th_s, A_s, ln, lm, **kw)
    E, _ = dp_ref.backward(dxs, dms, ln, lm, Et, want_gap=True, **kw)
    _, dxds, dmds = dp_ref.adjoint_forward(dxs, dms, zt_s, None, ln, lm, **kw)
    for e in (E, noise):
        want = dp_ref.adjoint_backward(dxs, dms, dxds, dmds, e, ln, lm, **kw)
        got = band_adjoint_backward(dxs, dms, dxds, dmds, e, ln, lm, mode,
                                    operator)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def band_adjoint_forward(dxs, dms, zt_s, za_s, ln, lm, mode, operator):
    B, K, S = dxs.shape
    lo = MODE_BOUNDS[mode][2]
    vtd = torch.zeros(B)
    dxds, dmds = torch.empty_like(dxs), torch.empty_like(dxs)
    zero = torch.zeros(S)
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        rows = min(K, n + m + 1)
        v1 = v2 = torch.zeros(S)
        for r in range(rows):
            dxd = _shr(v1) - v1
            if za_s is None:
                dmd = _shr(v2) - v1
            else:
                dmd = _shr(v2) - za_s[b, r] - v1
            dxds[b, r], dmds[b, r] = dxd, dmd
            band = _band(S, r + 2, n, m, lo)
            _, (qx, qm, _) = smooth.max3(operator, dxs[b, r, band],
                                         dms[b, r, band],
                                         torch.zeros_like(dxd[band]))
            v = torch.zeros(S)
            if za_s is None:
                v[band] = (zt_s[b, r, band] + v1[band] + qx * dxd[band]
                           + qm * dmd[band])
            else:
                v[band] = (zt_s[b, r, band] + za_s[b, r, band] + v1[band]
                           + qx * dxd[band] + qm * dmd[band])
            if r + 2 == n + m and bool(band[n]):
                vtd[b] = v[n]
            v2, v1 = v1, v
        for r in range(rows, K):
            dxds[b, r] = zero - zero
            dmds[b, r] = zero - zero if za_s is None \
                else zero - za_s[b, r] - zero
    return vtd, dxds, dmds


@pytest.mark.parametrize("B,N,M", SHAPES)
@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("operator", ["softmax", "sparsemax", "hardmax"])
def test_band_adjoint_forward_equals_plain(B, N, M, mode, operator):
    th_s, A_s, ln, lm, _ = _problem(B * N + M + 2, B, N, M)
    rng = np.random.default_rng(B * M + N)
    zt_s, za_s = (skew(torch.tensor(rng.standard_normal((B, N, M)),
                                    dtype=torch.float32)) for _ in range(2))
    kw = dict(mode=mode, operator=operator)
    _, dxs, dms = dp_ref.forward(th_s, A_s, ln, lm, **kw)
    for za in (None, za_s):
        want = dp_ref.adjoint_forward(dxs, dms, zt_s, za, ln, lm, **kw)
        got = band_adjoint_forward(dxs, dms, zt_s, za, ln, lm, mode,
                                   operator)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
