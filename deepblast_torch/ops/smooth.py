"""Smoothed-max operators over the three DP transition arguments.

PyTorch counterpart of ``deepblast_tpu/ops/smooth.py``: the same
3-argument ``max3`` / ``hessian3`` for softmax, sparsemax and hardmax, with
the three argument planes kept as separate tensors and the arithmetic in
the same order, so both packages round alike.  The CUDA kernels in
``deepblast_torch/csrc/dp_kernels.cu`` carry the same formulas per cell.

``max3(op, ax, am, ay) -> (val, (px, pm, py))``
    Smoothed maximum and its gradient (the smoothed argmax).
``hessian3(op, (px, pm, py), (zx, zm, zy)) -> (hx, hm, hy)``
    Hessian-vector product of the smoothed max at ``p``.
"""

from __future__ import annotations

import torch

__all__ = ["max3", "hessian3", "OPERATORS"]


def _softmax_max3(ax, am, ay):
    mx = torch.maximum(torch.maximum(ax, am), ay)
    ex = torch.exp(ax - mx)
    em = torch.exp(am - mx)
    ey = torch.exp(ay - mx)
    s = ex + em + ey
    inv = 1.0 / s
    val = mx + torch.log(s)
    return val, (ex * inv, em * inv, ey * inv)


def _softmax_hessian3(p, z):
    px, pm, py = p
    zx, zm, zy = z
    prodx = px * zx
    prodm = pm * zm
    prody = py * zy
    tot = prodx + prodm + prody
    return (prodx - px * tot, prodm - pm * tot, prody - py * tot)


def _sparsemax_max3(ax, am, ay):
    """Euclidean projection of the 3-vector onto the simplex, closed form
    through a sorting network (no data-dependent control flow)."""
    a_hi = torch.maximum(ax, am)
    a_lo = torch.minimum(ax, am)
    z1 = torch.maximum(a_hi, ay)
    z3 = torch.minimum(a_lo, ay)
    z2 = torch.maximum(a_lo, torch.minimum(a_hi, ay))

    # support size: cond_k = z_k - cssv_k / k > 0, cssv_k = sum_{j<=k} z_j - 1
    c1 = z1 + z2 - 1.0
    c2 = c1 + z3
    cond2 = (2.0 * z2 > c1).to(z1.dtype)
    cond3 = (3.0 * z3 > c2).to(z1.dtype)
    rho = 1.0 + cond2 + cond3
    cssv = (z1 - 1.0) + cond2 * z2 + cond3 * z3
    tau = cssv / rho

    px = torch.clamp_min(ax - tau, 0.0)
    pm = torch.clamp_min(am - tau, 0.0)
    py = torch.clamp_min(ay - tau, 0.0)
    val = px * (ax - 0.5 * px) + pm * (am - 0.5 * pm) + py * (ay - 0.5 * py)
    return val, (px, pm, py)


def _sparsemax_hessian3(p, z):
    px, pm, py = p
    zx, zm, zy = z
    dt = px.dtype
    sx = (px > 0).to(dt)
    sm = (pm > 0).to(dt)
    sy = (py > 0).to(dt)
    support = sx + sm + sy
    prodx = sx * zx
    prodm = sm * zm
    prody = sy * zy
    avg = (prodx + prodm + prody) / torch.clamp_min(support, 1.0)
    return (prodx - sx * avg, prodm - sm * avg, prody - sy * avg)


def _hardmax_max3(ax, am, ay):
    """Exact max; the argmax splits ties evenly."""
    val = torch.maximum(torch.maximum(ax, am), ay)
    dt = ax.dtype
    ix = (ax == val).to(dt)
    im = (am == val).to(dt)
    iy = (ay == val).to(dt)
    inv = 1.0 / (ix + im + iy)
    return val, (ix * inv, im * inv, iy * inv)


def _hardmax_hessian3(p, z):
    zero = torch.zeros_like(z[0])
    return (zero, zero, zero)


OPERATORS = {
    "softmax": (_softmax_max3, _softmax_hessian3),
    "sparsemax": (_sparsemax_max3, _sparsemax_hessian3),
    "hardmax": (_hardmax_max3, _hardmax_hessian3),
}


def max3(operator: str, ax, am, ay):
    """Smoothed max of the three transition arguments and its gradient."""
    return OPERATORS[operator][0](ax, am, ay)


def hessian3(operator: str, p, z):
    """Hessian-vector product of the smoothed max at probabilities ``p``
    applied to tangents ``z`` (both 3-tuples of tensors)."""
    return OPERATORS[operator][1](p, z)
