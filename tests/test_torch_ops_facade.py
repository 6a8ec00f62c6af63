"""The port's ``ops`` façade against the JAX package's: the backend
registry (``register_backend``, ``set_default_backend``, mirroring
``tests/test_backend_registry.py``), the default read by every reader
(a call without a backend, the trainer's ``"auto"`` menu, ``--backend``
and ``config.json``'s check, the error messages), the decoders
(``AlignmentDecoder``, ``NeedlemanWunschDecoder``,
``SmithWatermanDecoder``) and the names ``deepblast_torch.ops`` exports.

Tolerance: the decoders' scores and expected alignments atol 1e-10 at
fp64 against the JAX decoders (scan backend), as ``test_torch_dp.py``;
tracebacks identical; the spy backend's outputs equal the default's
exactly (the same passes).
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepblast_torch.ops as tops
import deepblast_tpu.ops as jops
from deepblast_torch.cli import common as tcommon
from deepblast_torch.ops import dp as tdp
from deepblast_torch.train import trainer as ttrainer
import torch_threads  # noqa: F401  (PyTorch threads a worker)

ATOL = 1e-10


@pytest.fixture
def registry_guard():
    default = tdp.DEFAULT_BACKEND
    added = []
    yield added
    for name in added:
        tdp.BACKENDS.pop(name, None)
    tdp.DEFAULT_BACKEND = default


def _spy_backend(calls, name):
    class Spy(tdp.BACKENDS["pallas_bm"]):
        @staticmethod
        def forward(*args, **kw):
            calls.append(name)
            return tdp._Residuals.forward(*args, **kw)
    return Spy


def _problem(B=1, N=4, M=4, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal((B, N, M))),
            torch.tensor(rng.standard_normal((B, N, M)) - 1.0))


def test_later_default_registration_is_picked_up(registry_guard):
    theta, A = _problem()
    e0 = tdp.expected_alignment(theta, A)

    calls = []
    tdp.register_backend("spy", _spy_backend(calls, "spy"),
                         make_default=True)
    registry_guard.append("spy")
    e1 = tdp.expected_alignment(theta, A)
    assert calls == ["spy"], "default call did not route to the new default"
    torch.testing.assert_close(e1, e0, rtol=0, atol=0)

    # explicit name still wins over the default
    calls.clear()
    tdp.expected_alignment(theta, A, backend="pallas_bm")
    assert calls == []


def test_set_default_backend_rejects_unknown():
    with pytest.raises(ValueError, match="unknown DP backend 'nope'"):
        tdp.set_default_backend("nope")
    assert tdp.DEFAULT_BACKEND == "pallas_bm"


def test_every_reader_follows_the_default(registry_guard):
    """After ``set_default_backend`` a call without a backend, the trainer's
    ``"auto"`` menu (by the default's name), ``--backend``'s choices, the
    ``config.json`` check and ``get_backend``'s error agree on it."""
    calls = []
    tdp.register_backend("spy", _spy_backend(calls, "spy"))
    registry_guard.append("spy")
    cfg = ttrainer.DeepBLASTConfig()
    assert ttrainer.DeepBLAST._dp_dtype_menu(cfg) is not None  # pallas_bm
    tdp.set_default_backend("spy")
    assert tdp.get_backend(None) is tdp.BACKENDS["spy"]
    tdp.expected_alignment(*_problem())
    assert calls == ["spy"]
    # "auto" is on for the pallas backends only (trainer.py:208-227)
    assert ttrainer.DeepBLAST._dp_dtype_menu(cfg) is None
    assert ttrainer.DeepBLASTConfig.from_json(
        '{"backend": "spy"}').backend == "spy"
    args = tcommon.add_infra_args(tcommon.add_model_args(
        argparse.ArgumentParser())).parse_args(
        ["--train-pairs", "t", "--valid-pairs", "v", "-o", "o",
         "--backend", "spy"])
    assert tcommon.config_from_args(args).backend == "spy"
    with pytest.raises(ValueError, match="the default, 'spy'"):
        tdp.get_backend("nope")
    tdp.set_default_backend("pallas_long")
    assert tdp.get_backend(None) is tdp.BACKENDS["pallas_long"]
    with pytest.raises(ValueError, match="no stream-layout accessor"):
        tdp.expected_alignment_stream(*_problem())


def test_ops_exports_the_jax_names():
    names = {"AlignmentDecoder", "NeedlemanWunschDecoder",
             "SmithWatermanDecoder", "alignment_score", "expected_alignment",
             "traceback", "OPERATORS"}
    assert names <= set(dir(jops)) and names <= set(dir(tops))
    assert set(tops.OPERATORS) == set(jops.OPERATORS)
    assert tops.expected_alignment is tdp.expected_alignment


@pytest.mark.parametrize("decoder", ["AlignmentDecoder",
                                     "NeedlemanWunschDecoder",
                                     "SmithWatermanDecoder"])
@pytest.mark.parametrize("operator", ["softmax", "sparsemax", "hardmax"])
def test_decoders_match_jax(decoder, operator):
    B, N, M = 2, 9, 7
    theta, A = _problem(B, N, M, seed=len(decoder) + len(operator))
    ln, lm = np.array([N, 6]), np.array([M, 5])
    jdec = getattr(jops, decoder)(operator=operator)
    tdec = getattr(tops, decoder)(operator=operator)
    assert isinstance(tdec, torch.nn.Module) and not list(tdec.parameters())
    assert tdec.mode == jdec.mode
    jargs = (jnp.asarray(theta.numpy()), jnp.asarray(A.numpy()),
             (jnp.asarray(ln), jnp.asarray(lm)))
    targs = (theta, A, (ln, lm))

    np.testing.assert_allclose(tdec(*targs).numpy(),
                               np.asarray(jdec(*jargs)), rtol=0, atol=ATOL)
    E_t, EA_t = tdec.decode(*targs, return_gap=True)
    E_j, EA_j = jdec.decode(*jargs, return_gap=True)
    E = tdec.decode(*targs)
    torch.testing.assert_close(E, E_t, rtol=0, atol=0)
    for b in range(B):
        n, m = ln[b], lm[b]
        np.testing.assert_allclose(E_t[b, :n, :m].numpy(),
                                   np.asarray(E_j)[b, :n, :m], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(EA_t[b, :n, :m].numpy(),
                                   np.asarray(EA_j)[b, :n, :m], rtol=0,
                                   atol=ATOL)
        assert tdec.traceback(E_t[b, :n, :m]) == \
            type(jdec).traceback(np.asarray(E_j)[b, :n, :m])
