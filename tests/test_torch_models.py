"""The port's models with weights carried over from flax by
``params_from_jax``, against the JAX package's models.

Tolerances:
* StackedCNN and the linear head: fp64 end to end on both sides, atol 1e-9.
* NeuralAligner.potentials: both packages return float32 potentials (the
  JAX einsums use ``preferred_element_type=float32``), so float32 ulps:
  rtol 1e-6 / atol 1e-6.
* T5Encoder (tiny, fp64): the JAX encoder takes its RMSNorm variance and
  its attention scores in float32 by design (models/lm.py:214, :250), and
  the port does the same, so float32 rounding of sums taken in another
  order remains: atol 1e-5 on outputs of unit scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepblast_torch.models import aligner as taligner
from deepblast_torch.models import heads as theads
from deepblast_torch.models import lm as tlm
from deepblast_torch.models.convert import params_from_jax
from deepblast_tpu.models import aligner as jaligner
from deepblast_tpu.models import heads as jheads
from deepblast_tpu.models import lm as jlm
import torch_threads  # noqa: F401  (PyTorch threads a worker)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("layers,k_size", [(2, 5), (3, 3), (1, 5)])
def test_heads_match_flax(layers, k_size):
    rng = np.random.default_rng(layers)
    x = rng.standard_normal((3, 13, 6))
    lengths = np.array([13, 9, 4])
    kw = dict(embedding_dim=6, hidden_dim=16, layers=layers, k_size=k_size)
    jm = jheads.build_head("cnn", **kw)
    p = _f64(jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(lengths)))
    want = np.asarray(jm.apply(p, jnp.asarray(x), jnp.asarray(lengths)))
    tm = theads.build_head("cnn", dtype=torch.float64, **kw)
    tm.load_state_dict(params_from_jax(p))
    got = tm(torch.tensor(x), torch.tensor(lengths)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_heads_pad_invariant():
    """As tests/test_models.py::test_heads_pad_invariant: features at true
    positions do not depend on pad width or pad content."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 10, 6))
    lengths = torch.tensor([10, 7])
    m = theads.StackedCNN(6, 16, layers=2, k_size=5, dtype=torch.float64)
    xa = np.pad(x, ((0, 0), (0, 2), (0, 0)))
    xb = np.pad(x, ((0, 0), (0, 22), (0, 0)))
    xb[:, 10:, :] = rng.standard_normal((2, 22, 6))
    xb[1, 7:, :] = rng.standard_normal((25, 6))
    xa[1, 7:10, :] = 3.0
    with torch.no_grad():
        ya = m(torch.tensor(xa), lengths).numpy()
        yb = m(torch.tensor(xb), lengths).numpy()
    for b, L in enumerate([10, 7]):
        np.testing.assert_allclose(ya[b, :L], yb[b, :L], rtol=0, atol=1e-12)


def test_potentials_match_flax():
    rng = np.random.default_rng(1)
    hx = rng.standard_normal((2, 12, 6))
    hy = rng.standard_normal((2, 9, 6))
    ln, lm = np.array([12, 5]), np.array([9, 4])
    kw = dict(embedding_dim=6, hidden_dim=8, layers=2, k_size=3)
    jm = jaligner.NeuralAligner(**kw)
    jlen = (jnp.asarray(ln), jnp.asarray(lm))
    p = _f64(jm.init(jax.random.key(1), jnp.asarray(hx), jnp.asarray(hy),
                     jlen))
    tj, aj = jm.apply(p, jnp.asarray(hx), jnp.asarray(hy), jlen,
                      method=jaligner.NeuralAligner.potentials)
    tm = taligner.NeuralAligner(dtype=torch.float64, **kw)
    tm.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        tt, at = tm.potentials(torch.tensor(hx), torch.tensor(hy),
                               (torch.tensor(ln), torch.tensor(lm)))
    assert tt.dtype == at.dtype == torch.float32
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6,
                               atol=1e-6)


def test_softplus_has_no_threshold():
    """theta = logaddexp(x, 0) also above torch softplus's threshold 20."""
    m = taligner.NeuralAligner(embedding_dim=2, hidden_dim=2, layers=1,
                               dtype=torch.float64)
    with torch.no_grad():
        for lin in (m.match_embedding.linear, m.gap_embedding.linear):
            lin.weight.copy_(torch.eye(2) * 5.0)
            lin.bias.zero_()
        h = torch.ones((1, 1, 2), dtype=torch.float64)
        theta, _ = m.potentials(h, h)
    want = np.asarray(jax.nn.softplus(jnp.float32(50.0)))
    assert theta.item() == pytest.approx(float(want), rel=1e-7)


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_t5_encoder_matches_flax(ff):
    rng = np.random.default_rng(2)
    B, L = 3, 17
    tokens = rng.integers(0, 32, (B, L))
    mask = np.arange(L)[None, :] < np.array([17, 11, 5])[:, None]
    jm = jlm.T5Encoder(jlm.T5Config.tiny(dtype=jnp.float64,
                                         feed_forward_proj=ff))
    p = _f64(jm.init(jax.random.key(2), jnp.asarray(tokens)))
    want = np.asarray(jm.apply(p, jnp.asarray(tokens), jnp.asarray(mask)))
    tm = tlm.T5Encoder(tlm.T5Config.tiny(feed_forward_proj=ff),
                       dtype=torch.float64)
    tm.load_state_dict(params_from_jax(p))
    with torch.no_grad():
        got = tm(torch.tensor(tokens), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert not got[1, 11:].any() and not got[2, 5:].any()


def test_relative_position_bucket_matches_flax():
    rel = np.arange(-300, 301)[None, :] - np.arange(0, 5)[:, None]
    for nb, md in [(32, 128), (8, 20)]:
        want = np.asarray(jlm.relative_position_bucket(jnp.asarray(rel),
                                                       nb, md))
        got = tlm.relative_position_bucket(torch.tensor(rel), nb, md)
        np.testing.assert_array_equal(got.numpy(), want)


def test_params_from_jax_covers_every_parameter():
    """Every port parameter is filled from the flax tree, and nothing of
    the flax tree is left over."""
    jm = jlm.T5Encoder(jlm.T5Config.tiny())
    p = jm.init(jax.random.key(3), jnp.zeros((1, 4), jnp.int32))
    sd = params_from_jax(p)
    tm = tlm.T5Encoder(tlm.T5Config.tiny())
    assert set(sd) == set(tm.state_dict())
    n_flax = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(p))
    assert n_flax == sum(v.numel() for v in sd.values())
