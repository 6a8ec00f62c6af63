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

``skew``/``unskew`` are the plain PyTorch relayouts and the plain versions
of the CUDA ``skew``, ``skew_pair`` and ``unskew`` kernels
(``ops/dp_cuda.py``).  They carry the storage menu of ``ops/menu.py``:
``skew`` stores float32, bfloat16 or int16 fixed point
(``deepblast_tpu/ops/skew_bm.py:195`` ``skew_bm``), ``skew_pair`` is two
skews with ``skew_bm_pair``'s checks (``skew_bm.py:243-254``), and
``unskew`` returns float32 for a bfloat16 stream and dequantizes an int16
expectation stream at ``1 / 32767`` (``dp_bm.unskew_output``,
``dp_bm.py:370-376``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deepblast_torch.ops.menu import E_SCALE, compute_dtype, dequantize, \
    quantize

__all__ = ["skew", "skew_pair", "unskew"]


def skew(x, out_dtype=None, quant_scale=None):
    """Natural ``(B, N, M)`` -> stream ``(B, K, S)``:
    ``out[b, r, s] = x[b, s-1, r-s+1]`` where that cell exists, else 0.

    ``out_dtype`` is the storage type (default ``x``'s); with
    ``out_dtype=torch.int16`` the values are quantized at ``quant_scale``
    (:func:`deepblast_torch.ops.menu.quantize`, computed in ``x``'s type;
    zeros stay zero), and a bfloat16 store rounds ``x`` to nearest even
    (from float64 through float32, as XLA's convert does).

    A zero-pad then a flat reshape with the shorter row stride shifts row
    ``i`` right by ``i`` (no gather)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, M), got {tuple(x.shape)}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if (out_dtype == torch.int16) != (quant_scale is not None):
        raise ValueError("an int16 stream needs a quant_scale, and only an "
                         "int16 stream takes one")
    if out_dtype == torch.int16:
        x = quantize(x, quant_scale)
    else:
        x = x.to(out_dtype)
    B, N, M = x.shape
    K, S = N + M - 1, N + 1
    W = N + M
    y = F.pad(x, (0, N))                                  # (B, N, W)
    z = y.reshape(B, N * W)[:, :N * (W - 1)].reshape(B, N, W - 1)[:, :, :K]
    out = x.new_zeros((B, K, S))
    out[:, :, 1:] = z.transpose(1, 2)                     # z[b, i, r]
    return out


def skew_pair(x, y, out_dtype=None, quant_scale=None):
    """``(skew(x), skew(y))`` with one storage form for both; the operands
    must agree in shape and type (a silent cast would differ from two
    single skews)."""
    if x.shape != y.shape:
        raise ValueError(f"pair shapes differ: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if x.dtype != y.dtype:
        raise ValueError(f"pair dtypes differ: {x.dtype} vs {y.dtype}")
    return (skew(x, out_dtype, quant_scale), skew(y, out_dtype, quant_scale))


def unskew(s, N: int, M: int):
    """Stream ``(B, K, S)`` -> natural ``(B, N, M)``:
    ``out[b, i, j] = s[b, i+j, i+1]`` (inverse of :func:`skew` on the
    cells that exist), in float32 for a bfloat16 stream and dequantized
    (``q / 32767``, float32) for an int16 expectation stream."""
    if s.dtype == torch.int16:
        s = dequantize(s, 1.0 / E_SCALE)
    else:
        s = s.to(compute_dtype(s.dtype))
    B, K, S = s.shape
    u = s[:, :, 1:N + 1].transpose(1, 2).reshape(B, N * K)  # u[b, i, r]
    flat = F.pad(u, (0, N))
    return flat.reshape(B, N, K + 1)[:, :, :M]
