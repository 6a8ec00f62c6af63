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
once and that every stored pair is aligned.  Tolerance: none
(``torch.equal``), in float32, bfloat16 and int16, at tiles that do not
divide K or S and at the kernel's own 32 x 128 tile.
"""

import numpy as np
import pytest
import torch

from deepblast_torch.ops.menu import quantize
from deepblast_torch.ops.skew import skew

# (B, N, M, R, C): N = 1, M = 1, N < M, N > M, K and S not multiples of
# the tile (a small one, and the kernel's 32 x 128 at S past one tile)
CASES = [(1, 1, 1, 4, 6), (2, 1, 17, 4, 6), (3, 17, 1, 4, 6),
         (2, 5, 9, 4, 6), (2, 40, 11, 4, 6), (1, 1, 1, 32, 128),
         (2, 40, 11, 32, 128), (1, 70, 300, 32, 128),
         (2, 130, 70, 32, 128)]
FORMS = [(torch.float32, None), (torch.bfloat16, None),
         (torch.int16, 2047.9375)]


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
