"""The port's anti-diagonal stream layout and its plain relayouts.

Every DP pass walks the ``K = N + M - 1`` anti-diagonals of the
``(N+1) x (M+1)`` DP matrix, one diagonal per step.  The port stores a
per-cell quantity batch-major as ``(B, K, S)`` with ``S = N + 1`` slots:
0-based cell ``(i, j)`` of a pair's ``(N, M)`` matrix sits at
``[b, i + j, i + 1]`` (diagonal ``k = i + j + 2`` of the 1-based DP matrix
at row ``k - 2``, slot = DP row ``i + 1``; slot 0 is the DP border).

This is the layout of the scan oracle (``deepblast_tpu/ops/dp_scan.py``,
``(K, B, N+1)``) with the batch axis moved first, so each pair's stream is
one contiguous block and a pair's cell ``(i, j)`` has the *affine* offset
``b*K*S + 1 + i*(S+1) + j*S`` that the C traceback walks directly.  The
TPU's compact mod-Mp row fold and 8x128 tiling (``ops/skew_bm.py``) have
no counterpart here.

``skew``/``unskew`` are the plain PyTorch relayouts; ``skew`` is also the
plain version of the CUDA ``skew`` kernel (``ops/dp_cuda.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["skew", "unskew"]


def skew(x):
    """Natural ``(B, N, M)`` -> stream ``(B, K, S)``:
    ``out[b, r, s] = x[b, s-1, r-s+1]`` where that cell exists, else 0.

    A zero-pad then a flat reshape with the shorter row stride shifts row
    ``i`` right by ``i`` (no gather)."""
    B, N, M = x.shape
    K, S = N + M - 1, N + 1
    W = N + M
    y = F.pad(x, (0, N))                                  # (B, N, W)
    z = y.reshape(B, N * W)[:, :N * (W - 1)].reshape(B, N, W - 1)[:, :, :K]
    out = x.new_zeros((B, K, S))
    out[:, :, 1:] = z.transpose(1, 2)                     # z[b, i, r]
    return out


def unskew(s, N: int, M: int):
    """Stream ``(B, K, S)`` -> natural ``(B, N, M)``:
    ``out[b, i, j] = s[b, i+j, i+1]`` (inverse of :func:`skew` on the
    cells that exist)."""
    B, K, S = s.shape
    u = s[:, :, 1:N + 1].transpose(1, 2).reshape(B, N * K)  # u[b, i, r]
    flat = F.pad(u, (0, N))
    return flat.reshape(B, N, K + 1)[:, :, :M]
