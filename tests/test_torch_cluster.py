"""The split the CUDA Q kernels rely on, on the CPU: one pair's slots cut
into C ranges that exchange only edge slots give the plain passes'
outputs bit for bit.

``csrc/dp_kernels.cu`` runs all four Q kernels (``forward_q_kernel``,
``backward_q_kernel``, ``adjoint_forward_q_kernel`` and
``adjoint_backward_q_kernel``) as B clusters of C CTAs, CTA c owning the
contiguous slots ``[c Sc, (c+1) Sc)`` of every diagonal.  The
``split_*`` functions below restate that, one pair at a time: each range
keeps only its own slots of the rows it carries and gets its edge values
a diagonal from its neighbour, through a ring three diagonals deep that
the neighbour stores into (the kernels' ``xedge``; each entry is tagged
with its diagonal, and a read checks the tag):

* the forward, diagonals ascending, carries V rows r-1 and r-2 and reads
  from the range on its left V[r-1] and V[r-2] at ``c Sc - 1``;
  ``(val, Q) = max3(A + shr(V[r-1]), shr(V[r-2]), A + V[r-1])`` at every
  slot, ``V = theta + val`` where the cell is valid, A read at every slot
  and theta only where the cell is valid;
* the adjoint forward, its tangent, the same way with Vd:
  ``xd = Za + shr(Vd[r-1])``, ``md = shr(Vd[r-2])``, ``yd = Za + Vd[r-1]``,
  ``Vd = ((Zt + Qx xd) + Qm md) + Qy yd`` where the cell is valid and
  ``Qd = hessian3(Q, (xd, md, yd))`` at every slot; Q and Za read at every
  slot, Zt only where the cell is valid (without Za, ``xd = shr(Vd[r-1])``
  and ``yd = Vd[r-1]``);
* the backward, rows descending, carries the products ``X = Qx E``,
  ``M = Qm E`` and ``Y = Qy E`` of the rows before, sums
  ``E = (shl(X[r+1]) + shl(M[r+2])) + Y[r+1]`` in the plain order, masks
  it, adds Et at the terminal, and reads from the range on its right
  X[r+1] and M[r+1] at ``(c+1) Sc``; Q is read on the band and wherever E
  is non-zero off it (the terminal of sw with n = 1 or m = 1), each
  element at most once (``_Once``); where E is zero the products and EA
  are zero without reading Q;
* the adjoint backward, rows descending, carries the products
  ``X = Qdx E + Qx Ed``, ``M = Qdm E + Qm Ed``, ``Yd = Qdy E`` and
  ``Yq = Qy Ed`` of the rows before, sums
  ``Ed = shl(X[r+1]) + shl(M[r+2]) + Yd[r+1] + Yq[r+1]`` in the plain
  order, and reads from the range on its right X[r+1] and M[r+1] at
  ``(c+1) Sc``; E is read at every slot, Q and Qd on the band and
  wherever E is non-zero off it, and each stream element at most once
  (``_Once``); where E and Ed are both zero the products and EdA are
  zero without reading Q or Qd.

Cases: C = 1, 2, 3 and 8 ranges of ``ceil(S / C)`` slots, and C = 3 and 8
with the last one or three ranges past S (padding only, as a CTA whose
slots all lie past the pair), on ragged pairs (a last pair of whole
diagonals of padding), nw and sw x softmax, sparsemax and hardmax (the
backward, which has no operator, with and without the gap output, on the
Q of each operator in turn), the adjoint forward with and without Za, the
adjoint backward on the plain backward's E and on an E that is noise at
every slot; sw pairs of n = 1 or m = 1, whose terminal lies off the band,
for the backward; and all four with bf16 Q streams (``Q_DTYPE``: the
forward rounds its stores, the others widen what they read; ``_Once``
reads into float32) in two of those splits.  Tolerance: none (``torch.equal``: every cell takes the
same float32 operations; a zero the plain version forms as -0.0 where the
split stores +0.0 compares equal).
"""

import numpy as np
import pytest
import torch

from deepblast_torch.ops import dp_ref, smooth
from deepblast_torch.ops.dp_ref import MODE_BOUNDS
from deepblast_torch.ops.skew import skew
import torch_threads  # noqa: F401  (PyTorch threads a worker)

RING = 3
OPERATORS = ["softmax", "sparsemax", "hardmax"]
# (C, ranges past S)
SPLITS = [(1, 0), (2, 0), (3, 0), (8, 0), (3, 1), (8, 3)]


def _problem(seed, B=2, N=17, M=23):
    rng = np.random.default_rng(seed)
    theta = torch.tensor(rng.standard_normal((B, N, M)), dtype=torch.float32)
    A = torch.tensor(rng.standard_normal((B, N, M)) - 1.0,
                     dtype=torch.float32)
    ln = rng.integers(1, N + 1, size=B)
    lm = rng.integers(1, M + 1, size=B)
    ln[0], lm[0] = N, M
    ln[-1] = max(1, N // 5)                       # whole rows of padding
    i32 = dict(dtype=torch.int32)
    return (skew(theta), skew(A), torch.tensor(ln, **i32),
            torch.tensor(lm, **i32))


def _width(S, C, spare):
    """Slots a range: ceil(S / (C - spare)), so the last ``spare`` ranges
    lie past S."""
    return -(-S // (C - spare))


def _valid(slots, k, n, m, lo):
    j = k - slots
    return (slots >= lo) & (j >= lo) & (slots <= n) & (j <= m)


class _Once:
    """Reads of one ``(B, K, S)`` stream, each element at most once; slots
    past S read as 0."""

    def __init__(self, x):
        self.x = x
        self.seen = torch.zeros(x.shape, dtype=torch.bool)

    def read(self, b, r, slots, where):
        out = torch.zeros(slots.shape)
        take = where & (slots < self.x.shape[2])
        idx = slots[take]
        assert not self.seen[b, r, idx].any(), "an element read twice"
        self.seen[b, r, idx] = True
        out[take] = self.x[b, r, idx].float()   # a bf16 Q widened
        return out


class _Ring:
    """A neighbour's edge values, tagged with their diagonal, RING deep."""

    def __init__(self):
        self.slots = [None] * RING

    def store(self, r, *values):
        self.slots[r % RING] = (r, values)

    def load(self, r):
        tag, values = self.slots[r % RING]
        assert tag == r, "an edge value overwritten before it was read"
        return values


def split_forward_q(th_s, A_s, ln, lm, mode, operator, C, spare,
                    q_dtype=torch.float32):
    B, K, S = th_s.shape
    lo = MODE_BOUNDS[mode][0]
    Sc = _width(S, C, spare)
    zero = torch.zeros(())
    vt = torch.zeros(B)
    qs = [torch.full(th_s.shape, float("nan"), dtype=q_dtype)
          for _ in range(3)]
    th, ad = _Once(th_s), _Once(A_s)
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        slots = [torch.arange(c * Sc, (c + 1) * Sc) for c in range(C)]
        v1 = [torch.zeros(Sc) for _ in range(C)]
        v2 = [torch.zeros(Sc) for _ in range(C)]
        l1, l2 = [0.0] * C, [0.0] * C
        rings = [_Ring() for _ in range(C)]       # stored by the left range
        for r in range(K):
            k = r + 2
            vn = []
            for c in range(C):
                s = slots[c]
                valid = _valid(s, k, n, m, lo)
                a = ad.read(b, r, s, torch.ones_like(valid))
                t = th.read(b, r, s, valid)
                left1 = torch.cat([torch.tensor([l1[c]]), v1[c][:-1]])
                left2 = torch.cat([torch.tensor([l2[c]]), v2[c][:-1]])
                val, q = smooth.max3(operator, a + left1, left2, a + v1[c])
                real = s < S
                for out, part in zip(qs, q):
                    out[b, r, s[real]] = part[real].to(out.dtype)
                v = torch.where(valid, t + val, zero)
                at = (s == n) & (k == n + m)
                if at.any():
                    vt[b] = v[at][0]
                vn.append(v)
                if c + 1 < C:
                    rings[c + 1].store(r, v[-1])
            # after the diagonal's barrier: each range's left edge of row r
            for c in range(C):
                left = rings[c].load(r)[0] if c else 0.0
                l2[c], l1[c] = l1[c], left
                v2[c], v1[c] = v1[c], vn[c]
    return (vt, *qs)


def split_backward_q(qx, qm, qy, ln, lm, Et, mode, want_gap, C, spare):
    B, K, S = qx.shape
    lo = MODE_BOUNDS[mode][1]
    Sc = _width(S, C, spare)
    zero = torch.zeros(())
    E = torch.full(qx.shape, float("nan"))
    EA = torch.full(qx.shape, float("nan")) if want_gap else None
    streams = [_Once(x) for x in (qx, qm, qy)]
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        slots = [torch.arange(c * Sc, (c + 1) * Sc) for c in range(C)]
        zeros = [torch.zeros(Sc) for _ in range(C)]
        x1, m1, m2, y1 = (list(zeros) for _ in range(4))
        rx, rma, rmb = [0.0] * C, [0.0] * C, [0.0] * C
        rings = [_Ring() for _ in range(C)]      # stored by the right range
        for r in reversed(range(K)):
            new = []
            for c in range(C):
                s = slots[c]
                band = _valid(s, r + 2, n, m, lo)
                xr = torch.cat([x1[c][1:], torch.tensor([rx[c]])])
                mr = torch.cat([m2[c][1:], torch.tensor([rmb[c]])])
                e = torch.where(band, (xr + mr) + y1[c], zero)
                term = (s == n) & (r + 2 == n + m)
                e = torch.where(term, e + Et[b], e)
                need = band | (e != 0)
                ax, am, ay = (x.read(b, r, s, need) for x in streams)
                x = torch.where(need, ax * e, zero)
                mm = torch.where(need, am * e, zero)
                y = torch.where(need, ay * e, zero)
                real = s < S
                E[b, r, s[real]] = e[real]
                if want_gap:
                    ea = torch.where(need, e * (ax + ay), zero)
                    EA[b, r, s[real]] = ea[real]
                new.append((x, mm, y))
                if c > 0:
                    rings[c - 1].store(r, x[0], mm[0])
            # after the row's barrier: each range's right edge of row r
            for c in range(C):
                x, mm, y = new[c]
                rmb[c] = rma[c]
                rx[c], rma[c] = rings[c].load(r) if c + 1 < C else (0.0, 0.0)
                x1[c], m2[c], m1[c], y1[c] = x, m1[c], mm, y
    return E, EA


def split_adjoint_forward_q(qx, qm, qy, zt_s, za_s, ln, lm, mode, operator,
                            C, spare):
    B, K, S = qx.shape
    lo = MODE_BOUNDS[mode][2]
    Sc = _width(S, C, spare)
    zero = torch.zeros(())
    vtd = torch.zeros(B)
    qds = [torch.full(qx.shape, float("nan")) for _ in range(3)]
    q_in = [_Once(x) for x in (qx, qm, qy)]
    zt, za = _Once(zt_s), za_s is not None and _Once(za_s)
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        slots = [torch.arange(c * Sc, (c + 1) * Sc) for c in range(C)]
        v1 = [torch.zeros(Sc) for _ in range(C)]
        v2 = [torch.zeros(Sc) for _ in range(C)]
        l1, l2 = [0.0] * C, [0.0] * C
        rings = [_Ring() for _ in range(C)]       # stored by the left range
        for r in range(K):
            k = r + 2
            vn = []
            for c in range(C):
                s = slots[c]
                valid = _valid(s, k, n, m, lo)
                every = torch.ones_like(valid)
                q = [x.read(b, r, s, every) for x in q_in]
                z = zt.read(b, r, s, valid)
                left1 = torch.cat([torch.tensor([l1[c]]), v1[c][:-1]])
                left2 = torch.cat([torch.tensor([l2[c]]), v2[c][:-1]])
                if za:
                    a = za.read(b, r, s, every)
                    xd, yd = a + left1, a + v1[c]
                else:
                    xd, yd = left1, v1[c]
                md = left2
                vd = z + q[0] * xd + q[1] * md + q[2] * yd
                real = s < S
                for out, part in zip(qds, smooth.hessian3(operator, q,
                                                          (xd, md, yd))):
                    out[b, r, s[real]] = part[real]
                v = torch.where(valid, vd, zero)
                at = (s == n) & (k == n + m)
                if at.any():
                    vtd[b] = v[at][0]
                vn.append(v)
                if c + 1 < C:
                    rings[c + 1].store(r, v[-1])
            # after the diagonal's barrier: each range's left edge of row r
            for c in range(C):
                left = rings[c].load(r)[0] if c else 0.0
                l2[c], l1[c] = l1[c], left
                v2[c], v1[c] = v1[c], vn[c]
    return (vtd, *qds)


def split_adjoint_backward_q(qx, qm, qy, qdx, qdm, qdy, E, ln, lm, mode, C,
                             spare):
    B, K, S = qx.shape
    lo = MODE_BOUNDS[mode][3]
    Sc = _width(S, C, spare)
    zero = torch.zeros(())
    Ed = torch.full(qx.shape, float("nan"))
    EdA = torch.full(qx.shape, float("nan"))
    streams = [_Once(x) for x in (qx, qm, qy, qdx, qdm, qdy)]
    e_in = _Once(E)
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        slots = [torch.arange(c * Sc, (c + 1) * Sc) for c in range(C)]
        zeros = [torch.zeros(Sc) for _ in range(C)]
        x1, m1, m2, yd1, yq1 = (list(zeros) for _ in range(5))
        rx, rma, rmb = [0.0] * C, [0.0] * C, [0.0] * C
        rings = [_Ring() for _ in range(C)]      # stored by the right range
        for r in reversed(range(K)):
            new = []
            for c in range(C):
                s = slots[c]
                band = _valid(s, r + 2, n, m, lo)
                e = e_in.read(b, r, s, torch.ones_like(band))
                need = band | (e != 0)
                ax, am, ay, hx, hm, hy = (x.read(b, r, s, need)
                                          for x in streams)
                xr = torch.cat([x1[c][1:], torch.tensor([rx[c]])])
                mr = torch.cat([m2[c][1:], torch.tensor([rmb[c]])])
                ed = torch.where(band, xr + mr + yd1[c] + yq1[c], zero)
                x = torch.where(need, hx * e + ax * ed, zero)
                mm = torch.where(need, hm * e + am * ed, zero)
                yd = torch.where(need, hy * e, zero)
                yq = torch.where(need, ay * ed, zero)
                eda = torch.where(need, ed * (ax + ay) + e * (hx + hy), zero)
                real = s < S
                Ed[b, r, s[real]] = ed[real]
                EdA[b, r, s[real]] = eda[real]
                new.append((x, mm, yd, yq))
                if c > 0:
                    rings[c - 1].store(r, x[0], mm[0])
            # after the row's barrier: each range's right edge of row r
            for c in range(C):
                x, mm, yd, yq = new[c]
                rmb[c] = rma[c]
                rx[c], rma[c] = rings[c].load(r) if c + 1 < C else (0.0, 0.0)
                x1[c], m2[c], m1[c] = x, m1[c], mm
                yd1[c], yq1[c] = yd, yq
    return Ed, EdA


@pytest.mark.parametrize("C,spare", SPLITS)
@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("operator", ["softmax", "sparsemax", "hardmax"])
def test_split_forward_q_equals_plain(C, spare, mode, operator):
    th_s, A_s, ln, lm = _problem(7 * C + spare)
    want = dp_ref.forward_q(th_s, A_s, ln, lm, mode=mode, operator=operator)
    got = split_forward_q(th_s, A_s, ln, lm, mode, operator, C, spare)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("C,spare", SPLITS)
@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("operator", ["softmax", "sparsemax", "hardmax"])
def test_split_adjoint_backward_q_equals_plain(C, spare, mode, operator):
    th_s, A_s, ln, lm = _problem(11 * C + spare)
    kw = dict(mode=mode, operator=operator)
    _, *qs = dp_ref.forward_q(th_s, A_s, ln, lm, **kw)
    rng = np.random.default_rng(C + spare)
    Et = torch.tensor(rng.standard_normal(2), dtype=torch.float32)
    E, _ = dp_ref.backward_q(*qs, ln, lm, Et, mode=mode)
    zt_s = skew(torch.tensor(rng.standard_normal((2, 17, 23)),
                             dtype=torch.float32))
    _, *qds = dp_ref.adjoint_forward_q(*qs, zt_s, None, ln, lm, **kw)
    noise = torch.tensor(rng.standard_normal(E.shape), dtype=torch.float32)
    for e in (E, noise):
        want = dp_ref.adjoint_backward_q(*qs, *qds, e, ln, lm, mode=mode)
        got = split_adjoint_backward_q(*qs, *qds, e, ln, lm, mode, C, spare)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("C,spare", SPLITS)
@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("want_gap", [False, True])
def test_split_backward_q_equals_plain(C, spare, mode, want_gap):
    rng = np.random.default_rng(13 * C + spare)
    Et = torch.tensor(rng.standard_normal(2), dtype=torch.float32)
    shapes = [(17, 23), (1, 9), (9, 1)]           # n = 1, m = 1: sw's
    for i, operator in enumerate(OPERATORS):      # terminal off the band
        th_s, A_s, ln, lm = _problem(13 * C + spare + i, 2, *shapes[i])
        _, *qs = dp_ref.forward_q(th_s, A_s, ln, lm, mode=mode,
                                  operator=operator)
        want = dp_ref.backward_q(*qs, ln, lm, Et, mode=mode,
                                 want_gap=want_gap)
        got = split_backward_q(*qs, ln, lm, Et, mode, want_gap, C, spare)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            assert g is None or torch.equal(g, w)


@pytest.mark.parametrize("C,spare", SPLITS)
@pytest.mark.parametrize("mode", ["nw", "sw"])
@pytest.mark.parametrize("operator", OPERATORS)
def test_split_adjoint_forward_q_equals_plain(C, spare, mode, operator):
    th_s, A_s, ln, lm = _problem(17 * C + spare)
    _, *qs = dp_ref.forward_q(th_s, A_s, ln, lm, mode=mode,
                              operator=operator)
    rng = np.random.default_rng(C + spare + 1)
    zt_s, za_s = (skew(torch.tensor(rng.standard_normal((2, 17, 23)),
                                    dtype=torch.float32)) for _ in range(2))
    for za in (None, za_s):
        want = dp_ref.adjoint_forward_q(*qs, zt_s, za, ln, lm, mode=mode,
                                        operator=operator)
        got = split_adjoint_forward_q(*qs, zt_s, za, ln, lm, mode, operator,
                                      C, spare)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("C,spare,mode,operator", [
    (3, 1, "nw", "softmax"), (8, 3, "sw", "sparsemax")])
def test_split_q_passes_with_bf16_q_equal_plain(C, spare, mode, operator):
    """bf16 Q storage (the kernels' ``TQ = __nv_bfloat16`` instances): the
    forward's rounded Q streams, and the three passes that read them
    (the backward with EA, the adjoint forward with Za, the adjoint
    backward on the backward's E), bit for bit against the plain passes
    with ``q_dtype=torch.bfloat16``."""
    th_s, A_s, ln, lm = _problem(19 * C + spare)
    kw = dict(mode=mode, operator=operator)
    bf16 = torch.bfloat16
    want = dp_ref.forward_q(th_s, A_s, ln, lm, q_dtype=bf16, **kw)
    got = split_forward_q(th_s, A_s, ln, lm, mode, operator, C, spare, bf16)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    qs = want[1:]
    assert all(q.dtype == bf16 for q in qs)
    rng = np.random.default_rng(C + spare + 2)
    Et = torch.tensor(rng.standard_normal(2), dtype=torch.float32)
    E, EA = dp_ref.backward_q(*qs, ln, lm, Et, mode=mode, want_gap=True)
    for g, w in zip(split_backward_q(*qs, ln, lm, Et, mode, True, C, spare),
                    (E, EA)):
        assert g.dtype == w.dtype == torch.float32 and torch.equal(g, w)
    zt_s, za_s = (skew(torch.tensor(rng.standard_normal((2, 17, 23)),
                                    dtype=torch.float32)) for _ in range(2))
    want = dp_ref.adjoint_forward_q(*qs, zt_s, za_s, ln, lm, **kw)
    got = split_adjoint_forward_q(*qs, zt_s, za_s, ln, lm, mode, operator,
                                  C, spare)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and torch.equal(g, w)
    qds = want[1:]
    want = dp_ref.adjoint_backward_q(*qs, *qds, E, ln, lm, mode=mode)
    got = split_adjoint_backward_q(*qs, *qds, E, ln, lm, mode, C, spare)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and torch.equal(g, w)
