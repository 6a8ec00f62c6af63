"""The port's smoothed-max operators (deepblast_torch.ops.smooth) against
the JAX package's (deepblast_tpu.ops.smooth), at fp64.

Tolerance: atol 1e-12 — the same formulas in the same order, so only the
last bits of exp/log may differ.  Inputs include exact ties (integer
values), where hardmax splits the argmax evenly and sparsemax's support
test sits on its boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepblast_torch.ops import smooth as tsmooth
from deepblast_tpu.ops import smooth as jsmooth
import torch_threads  # noqa: F401  (PyTorch threads a worker)

OPS = ["softmax", "sparsemax", "hardmax"]
ATOL = 1e-12


def _args(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, 64)) * 3.0
    a[:, :16] = rng.integers(-2, 3, (3, 16))        # exact ties
    a[:, 16:20] = [[0.0], [0.0], [0.0]]              # three-way ties
    return a


@pytest.mark.parametrize("operator", OPS)
def test_max3_matches_jax(operator):
    a = _args(0)
    vj, pj = jsmooth.max3(operator, *map(jnp.asarray, a))
    vt, pt = tsmooth.max3(operator, *map(torch.tensor, a))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                               atol=ATOL)
    for got, want in zip(pt, pj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
    # the argmax is a probability vector
    np.testing.assert_allclose(sum(p.numpy() for p in pt), 1.0, rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("operator", OPS)
def test_hessian3_matches_jax(operator):
    a = _args(1)
    z = np.random.default_rng(2).standard_normal((3, 64))
    _, pj = jsmooth.max3(operator, *map(jnp.asarray, a))
    _, pt = tsmooth.max3(operator, *map(torch.tensor, a))
    hj = jsmooth.hessian3(operator, pj, tuple(map(jnp.asarray, z)))
    ht = tsmooth.hessian3(operator, pt, tuple(map(torch.tensor, z)))
    for got, want in zip(ht, hj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


def test_hardmax_splits_ties_evenly():
    one = torch.ones(1, dtype=torch.float64)
    _, (px, pm, py) = tsmooth.max3("hardmax", one, one, 0 * one)
    assert (px.item(), pm.item(), py.item()) == (0.5, 0.5, 0.0)
