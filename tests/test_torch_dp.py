"""The port's plain DP (deepblast_torch.ops.dp on CPU tensors, i.e.
ops.dp_ref) against the JAX package's scan backend at fp64, and the
port's traceback walks.

Tolerance: atol 1e-10 on Vt and on E at every valid cell — both sides
run the same recurrences in fp64; the port takes the max3 of the
differences (Dx, Dm, 0) where the scan takes it of the raw arguments, which
moves only the last bits.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepblast_torch.ops import dp as tdp
from deepblast_torch.ops import dp_cuda
from deepblast_torch.ops import skew as tskew
from deepblast_tpu.ops import dp as jdp
from deepblast_tpu.ops.skew import skew as jskew
import torch_threads  # noqa: F401  (PyTorch threads a worker)

ATOL = 1e-10
SHAPES = [(3, 24, 17), (2, 40, 96), (2, 96, 40)]
MODES = ["nw", "sw"]
OPS = ["softmax", "sparsemax", "hardmax"]
DATA = os.path.join(os.path.dirname(__file__), "data")


def _problem(seed, B, N, M):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((B, N, M))
    A = rng.standard_normal((B, N, M)) - 1.0
    ln = rng.integers(3, N + 1, size=B)
    lm = rng.integers(3, M + 1, size=B)
    ln[0], lm[0] = N, M
    return theta, A, ln, lm


def _seed(seed, B):
    """Terminal seeds Et > 0 (E is linear in Et; a positive scale keeps
    the traceback)."""
    return np.random.default_rng(seed).uniform(0.5, 1.5, size=B)


@pytest.mark.parametrize("B,N,M", SHAPES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("operator", OPS)
def test_plain_dp_matches_scan(B, N, M, mode, operator):
    theta, A, ln, lm = _problem(B * N + M, B, N, M)
    jargs = (jnp.asarray(theta), jnp.asarray(A))
    jlen = (jnp.asarray(ln), jnp.asarray(lm))
    kw = dict(mode=mode, operator=operator)
    vt_j = np.asarray(jdp.alignment_score(*jargs, jlen, backend="scan", **kw))
    Et = _seed(B + N, B)
    E_j = np.asarray(jdp.expected_alignment(*jargs, jlen, jnp.asarray(Et),
                                            backend="scan", **kw))

    targs = (torch.tensor(theta), torch.tensor(A))
    vt_t = tdp.alignment_score(*targs, (ln, lm), **kw)
    E_s = tdp.expected_alignment_stream(*targs, (ln, lm), torch.tensor(Et),
                                        **kw)
    assert vt_t.dtype == torch.float64 and E_s.shape == (B, N + M - 1, N + 1)
    np.testing.assert_allclose(vt_t.numpy(), vt_j, rtol=0, atol=ATOL)
    E_t = tskew.unskew(E_s, N, M).numpy()
    for b in range(B):
        n, m = ln[b], lm[b]
        np.testing.assert_allclose(E_t[b, :n, :m], E_j[b, :n, :m], rtol=0,
                                   atol=ATOL)
        assert tdp.stream_cell(E_s, b, n - 1, m - 1) == E_t[b, n - 1, m - 1]
        # the walk on the stream is the JAX walk on the natural matrix
        assert tdp.traceback_stream(E_s, int(n), int(m), b) == \
            jdp.traceback(E_j[b, :n, :m])


def test_skew_layout_is_the_scan_layout_batch_first():
    """stream[b, r, s] = x[b, s-1, r-s+1]: the scan's (K, B, N) skew with
    the border slot prepended and the batch moved first; unskew inverts
    it."""
    x = np.random.default_rng(0).standard_normal((3, 7, 5))
    s = tskew.skew(torch.tensor(x))
    ref = np.transpose(np.asarray(jskew(jnp.asarray(x))), (1, 0, 2))
    np.testing.assert_array_equal(s[:, :, 1:].numpy(), ref)
    np.testing.assert_array_equal(s[:, :, 0].numpy(), 0.0)
    np.testing.assert_array_equal(tskew.unskew(s, 7, 5).numpy(), x)


@pytest.mark.parametrize("seed", range(4))
def test_c_walk_matches_python_walk(seed):
    """The native walk against the Python oracle, on matrices with ties
    (coarsely quantised values) and on the affine stream view."""
    rng = np.random.default_rng(seed)
    n, m = rng.integers(1, 30, size=2)
    g = np.round(rng.random((n, m)) * 4) / 4
    want = tdp._traceback_walk(lambda i, j: g[i, j], n, m)
    assert tdp.traceback(g) == want
    assert tdp.traceback(g.astype(np.float32)) == want
    # the same matrix placed in pair 1 of a stream
    s = np.zeros((2, n + m - 1, n + 1))
    s[1] = tskew.skew(torch.tensor(g[None]))[0].numpy()
    assert tdp.traceback_stream(s, n, m, 1) == want
    for bad in ((n + 1, m, 1), (n, m + 1, 1), (n, m, 2), (0, m, 0)):
        with pytest.raises(ValueError, match="outside a stream"):
            tdp.traceback_stream(s, *bad)


def test_traceback_dm_golden():
    """The JAX package's golden case (tests/test_golden_fixtures.py:32) on
    the reference's 25x23 expected-alignment fixture."""
    dm = np.loadtxt(os.path.join(DATA, "dm.txt"))
    decoded = tdp.traceback(dm)
    assert decoded[0][:2] == (0, 0)
    assert decoded[-1][:2] == (24, 22)
    assert "".join(str(s) for _, _, s in decoded) == (
        "2222222222222222210022220000000000000000000001")


def test_dispatch_by_device():
    """CPU tensors run the plain passes; other devices raise; the CUDA
    wrappers refuse CPU tensors instead of falling back."""
    before = dict(dp_cuda.LAUNCHES)
    theta = torch.zeros((1, 4, 3), device="meta")
    with pytest.raises(ValueError, match="no DP implementation"):
        tdp.alignment_score(theta, theta)
    x = torch.zeros((1, 4, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        dp_cuda.skew(x)
    n = torch.full((1,), 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dp_cuda.forward(x, x, n, n)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dp_cuda.backward(x, x, n, n, torch.ones(1))
    assert dp_cuda.LAUNCHES == before
