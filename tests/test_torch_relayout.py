"""The tile index map of the CUDA skew, on the CPU: ``tiled_skew`` restates
``skew_kernel`` / ``skew_pair_kernel`` (``csrc/dp_kernels.cu`` ``skew_body``)
tile by tile and is held to the plain relayout ``ops/skew.py`` ``skew``.

A tile is R diagonals ``[r0, r0+R)`` by C slots ``[s0, s0+C)`` of one pair.
Slot ``s`` of the tile holds natural row ``i = s-1``, whose cells in the
tile are the R contiguous columns ``j = r - s + 1`` for ``r`` in the tile:
the load reads each such row segment masked to ``s >= 1``, ``s < S`` and
``0 <= j < M`` into a ``(C, R)`` tile (a tile with no cell at all loads
nothing), and the store writes the tile's stream rows ``r < K`` over its
slots ``s < S``.  The 2-byte forms store aligned pairs of slots: position
``q`` of a row covers slots ``c = 2q - p`` and ``c + 1`` with ``p`` the
parity of the row's first element, so a pair starts at an even element;
a slot whose partner lies outside the tile is stored alone.  The
restatement also checks that every output element is written exactly
once and that every stored pair is aligned.

``tiled_unskew`` restates ``unskew_kernel``, whose tiles lie in natural
space: C natural rows ``[i0, i0+C)`` by R columns ``[j0, j0+R)`` of one
pair.  The tile's cells lie on the diagonals ``r`` in ``[i0+j0,
i0+j0+C+R-2]``; slot offset ``c`` in ``[0, R)`` of diagonal ``r`` is slot
``r - j0 - R + 2 + c``, natural cell ``(r - j0 - R + 1 + c, j0 + R - 1 -
c)``.  Each diagonal's run is read over the offsets that hold a cell of
the tile (the padding is never read), the 2-byte forms as the skew's
aligned pairs (one word where both halves hold a cell, else the half
that does), into the ``(C, R)`` tile; then each natural row of the tile
writes its R columns from ``j0``, masked to ``[0, M)``.  The
restatement checks that every natural cell is read once and written
once, that only loaded tile entries are written, and that every pair
read as one word is aligned.  Tolerance: none (``torch.equal``), in
float32, bfloat16 and int16, at tiles that do not divide N or M and at
the kernels' own tiles.
"""

import numpy as np
import pytest
import torch

from deepblast_torch.ops.menu import E_SCALE, dequantize, quantize
from deepblast_torch.ops.skew import skew, unskew
import torch_threads  # noqa: F401  (PyTorch threads a worker)

# (B, N, M, R, C): N = 1, M = 1, N < M, N > M, K and S not multiples of
# the tile (a small one, and the kernel's 32 x 128 at S past one tile)
CASES = [(1, 1, 1, 4, 6), (2, 1, 17, 4, 6), (3, 17, 1, 4, 6),
         (2, 5, 9, 4, 6), (2, 40, 11, 4, 6), (1, 1, 1, 32, 128),
         (2, 40, 11, 32, 128), (1, 70, 300, 32, 128),
         (2, 130, 70, 32, 128)]
FORMS = [(torch.float32, None), (torch.bfloat16, None),
         (torch.int16, 2047.9375)]
# the unskew's tile, columns x rows (UNSKEW_COLS x UNSKEW_ROWS in
# csrc/dp_kernels.cu)
UNSKEW_TILE = (32, 128)


def _store(v, out_dtype, scale):
    if out_dtype == torch.int16:
        return quantize(v, scale)
    return v.to(out_dtype)


def tiled_skew(x, out_dtype=torch.float32, quant_scale=None, R=32, C=128):
    B, N, M = x.shape
    K, S = N + M - 1, N + 1
    out = torch.zeros(B * K * S, dtype=out_dtype)
    writes = torch.zeros(B * K * S, dtype=torch.int64)
    pairs = out_dtype != torch.float32
    c_ = torch.arange(C)[:, None]
    lane = torch.arange(R)[None, :]
    for b in range(B):
        for r0 in range(0, K, R):
            for s0 in range(0, S, C):
                tile = torch.zeros((C, R))
                if r0 + R - s0 >= 0 and r0 - s0 - C + 2 < M:
                    s = (s0 + c_).expand(C, R)
                    j = r0 - s + 1 + lane
                    ok = (s >= 1) & (s < S) & (j >= 0) & (j < M)
                    tile[ok] = x[b, s[ok] - 1, j[ok]]
                for rr in range(min(R, K - r0)):
                    row = (b * K + r0 + rr) * S + s0
                    if not pairs:
                        c = torch.arange(C)
                        c = c[s0 + c < S]
                        idx = [c]
                    else:
                        c = 2 * torch.arange(C // 2 + 1) - row % 2
                        lo = (c >= 0) & (c < C) & (s0 + c < S)
                        hi = (c + 1 < C) & (s0 + c + 1 < S)
                        assert ((row + c[lo & hi]) % 2 == 0).all()
                        idx = [c[lo], c[hi] + 1]
                    for cc in idx:
                        out[row + cc] = _store(tile[cc, rr], out_dtype,
                                               quant_scale)
                        writes[row + cc] += 1
    assert (writes == 1).all()
    return out.reshape(B, K, S)


@pytest.mark.parametrize("B,N,M,R,C", CASES)
@pytest.mark.parametrize("out_dtype,scale", FORMS)
def test_tiled_skew_equals_plain(B, N, M, R, C, out_dtype, scale):
    rng = np.random.default_rng(B * N + M)
    x = torch.tensor(rng.standard_normal((B, N, M)) * 30.0,
                     dtype=torch.float32)      # saturates as int16
    want = skew(x, None if out_dtype == torch.float32 else out_dtype, scale)
    got = tiled_skew(x, out_dtype, scale, R, C)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


def _load(v):
    """A stream value as the unskew reads it: float32, bf16 widened, int16
    dequantized at 1 / 32767."""
    if v.dtype == torch.int16:
        return dequantize(v, 1.0 / E_SCALE)
    return v.float()


def tiled_unskew(s, N, M, R=32, C=128):
    B, K, S = s.shape
    flat = s.reshape(-1)
    out = torch.full((B * N * M,), float("nan"))
    reads = torch.zeros(B * N * M, dtype=torch.int64)
    writes = torch.zeros(B * N * M, dtype=torch.int64)
    pairs = s.element_size() == 2
    for b in range(B):
        for i0 in range(0, N, C):
            for j0 in range(0, M, R):
                tile = torch.full((C, R), float("nan"))
                for r in range(i0 + j0, min(K, i0 + j0 + C + R - 1)):
                    at = (b * K + r) * S + (r - j0 - R + 2)

                    def cell(c):
                        i, j = r - j0 - R + 1 + c, j0 + R - 1 - c
                        return ((c >= 0) & (c < R) & (i >= i0) & (i < i0 + C)
                                & (i < N) & (j < M))

                    if not pairs:
                        c = torch.arange(R)
                        idx = [c[cell(c)]]
                    else:
                        c = 2 * torch.arange(R // 2 + 1) - at % 2
                        lo, hi = cell(c), cell(c + 1)
                        assert ((at + c[lo & hi]) % 2 == 0).all()
                        idx = [c[lo], c[hi] + 1]
                    for cc in idx:
                        i, j = r - j0 - R + 1 + cc, j0 + R - 1 - cc
                        tile[i - i0, j - j0] = _load(flat[at + cc])
                        reads[(b * N + i) * M + j] += 1
                for ii in range(min(C, N - i0)):
                    j = j0 + torch.arange(R)
                    ok = j < M
                    at = (b * N + i0 + ii) * M + j[ok]
                    assert not torch.isnan(tile[ii, ok]).any()
                    out[at] = tile[ii, ok]
                    writes[at] += 1
    assert (reads == 1).all() and (writes == 1).all()
    return out.reshape(B, N, M)


# (B, N, M, R, C) for the unskew: R columns x C rows, tiles that do not
# divide N or M (small ones, and the kernel's own past one tile each way)
UNSKEW_CASES = [(1, 1, 1, 4, 6), (2, 1, 17, 4, 6), (3, 17, 1, 4, 6),
                (2, 5, 9, 4, 6), (2, 40, 11, 4, 6), (2, 11, 40, 6, 4),
                (1, 1, 1, *UNSKEW_TILE), (2, 40, 11, *UNSKEW_TILE),
                (1, 70, 300, *UNSKEW_TILE), (2, 130, 70, *UNSKEW_TILE),
                (1, 300, 67, *UNSKEW_TILE), (2, 129, 33, *UNSKEW_TILE)]


@pytest.mark.parametrize("B,N,M,R,C", UNSKEW_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int16])
def test_tiled_unskew_equals_plain(B, N, M, R, C, dtype):
    rng = np.random.default_rng(B * M + N)
    x = torch.tensor(rng.standard_normal((B, N, M)), dtype=torch.float32)
    if dtype == torch.int16:               # an expectation stream
        s = skew(x.abs() / (1.0 + x.abs()), torch.int16, float(E_SCALE))
    else:
        s = skew(x, None if dtype == torch.float32 else dtype)
    want = unskew(s, N, M)
    got = tiled_unskew(s, N, M, R, C)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
