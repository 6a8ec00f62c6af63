"""The port's plain DP against the JAX package's TPU kernels — the
``pallas_bm`` backend run in Pallas interpret mode on the CPU, as
tests/test_dp_bm.py runs it — at fp32:

* ``expected_alignment_stream`` (``dp_bm.decode_stream_bm``, the kernels
  that ``csrc/dp_kernels.cu``'s skew/forward/backward replace) through each
  package's stream accessor, at every valid cell, and its traceback;
* ``alignment_score`` (``dp_bm.forward_score_bm``, replaced by the
  score-only forward).

Tolerance: rtol 2e-5 / atol 2e-6, fp32 with the exp/log of two libraries.

Each mode x operator runs once, spread over the three ragged shapes.  Most
cases run the decode as one phase (``DECODE_PHASES=1``): interpret mode
costs ~5x more per phase, and tests/test_dp_bm.py shows the phase count
does not change E; one case runs the default phase plan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepblast_torch.ops import dp as tdp
from deepblast_tpu.ops import dp as jdp
from deepblast_tpu.ops import dp_bm
import torch_threads  # noqa: F401  (PyTorch threads a worker)

RTOL, ATOL = 2e-5, 2e-6


def _problem(seed, B, N, M):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((B, N, M)).astype(np.float32)
    A = (rng.standard_normal((B, N, M)) - 1.0).astype(np.float32)
    ln = rng.integers(3, N + 1, size=B)
    lm = rng.integers(3, M + 1, size=B)
    ln[0], lm[0] = N, M
    return theta, A, ln, lm


@pytest.mark.parametrize("B,N,M,mode,operator,phases", [
    (3, 24, 17, "nw", "softmax", 1),
    (3, 24, 17, "sw", "hardmax", 1),
    (2, 40, 96, "nw", "sparsemax", 1),
    (2, 40, 96, "sw", "softmax", 1),
    (2, 96, 40, "nw", "hardmax", 1),
    (2, 96, 40, "sw", "sparsemax", 1),
    (2, 96, 40, "nw", "softmax", dp_bm.DECODE_PHASES),
])
def test_plain_dp_matches_pallas_bm(monkeypatch, B, N, M, mode, operator,
                                    phases):
    monkeypatch.setattr(dp_bm, "DECODE_PHASES", phases)
    theta, A, ln, lm = _problem(B * N + M, B, N, M)
    kw = dict(mode=mode, operator=operator)
    jargs = (jnp.asarray(theta), jnp.asarray(A))
    jlen = (jnp.asarray(ln), jnp.asarray(lm))
    vt_j = np.asarray(jdp.alignment_score(*jargs, jlen, backend="pallas_bm",
                                          **kw))
    E_j = jdp.expected_alignment_stream(*jargs, jlen, backend="pallas_bm",
                                        **kw)
    E_j = jax.tree_util.tree_map(np.asarray, E_j)
    get = dp_bm._stream_accessor(E_j, N, M)

    targs = (torch.tensor(theta), torch.tensor(A))
    vt_t = tdp.alignment_score(*targs, (ln, lm), **kw).numpy()
    E_t = tdp.expected_alignment_stream(*targs, (ln, lm), **kw).numpy()
    np.testing.assert_allclose(vt_t, vt_j, rtol=RTOL, atol=ATOL)
    for b in range(B):
        n, m = int(ln[b]), int(lm[b])
        want = np.asarray([[get(b, i, j) for j in range(m)]
                           for i in range(n)])
        got = np.asarray([[tdp.stream_cell(E_t, b, i, j) for j in range(m)]
                          for i in range(n)])
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert tdp.traceback_stream(E_t, n, m, b) == \
            jdp.traceback_stream(E_j, n, m, b, backend="pallas_bm")
