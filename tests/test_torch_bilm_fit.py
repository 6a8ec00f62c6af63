"""Fit trajectories of the port's BiLM and RNN head against the JAX
trainer on the CPU (ROADMAP A2): ``lm_type="bilstm"`` (the frozen BiLM
with its one-hot identity channel), ``layer_type="rnn"`` (bidirectional
LSTM heads, whose second bias torch holds at zero as flax has none) and
bilstm with ``finetune`` (the BiLM trained with the aligner), from the
JAX init carried across by ``state_dicts_from_jax``, on
``tests/test_train.py``'s data with ``test_torch_train``'s tiny config
(the port on float32 residuals, JAX on its scan backend).

Tolerance: rtol 1e-4 on every logged value, as ``test_torch_train``'s
trajectory (float32, two libraries' exp, log, LSTM and AdamW arithmetic
over 6 steps; read: the largest relative difference below 1e-5); the
finetuned BiLM's weights rtol 1e-3 / atol 1e-5.
"""

import numpy as np
import pytest

from deepblast_torch.data import dataset as tds
from deepblast_torch.models import lm as tlm
from deepblast_torch.models.convert import state_dicts_from_jax
from deepblast_torch.train import trainer as ttrainer
from deepblast_tpu.data import dataset as jds
from deepblast_tpu.train import trainer as jtrainer
from test_torch_train import TINY, _Rec, _rows
from test_train import fixture_frame
import torch_threads  # noqa: F401  (PyTorch threads a worker)


def _bilm_trajectories(**fields):
    """Fit the port (float32 residuals) and the JAX trainer (scan backend)
    from the JAX init on the same data; the JAX BiLM, initialised through
    ``encode``, has no ``linear``, which the port's keeps unused."""
    cfg = dict(TINY, **fields)
    jmodel = jtrainer.DeepBLAST(jtrainer.DeepBLASTConfig(backend="scan",
                                                         **cfg))
    jmodel.state = jmodel.init()
    tmodel = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(
        dp_bf16_residuals=False, **cfg), device="cpu")
    sd = state_dicts_from_jax(jmodel.state)
    missing, unexpected = tmodel.lm.load_state_dict(sd["lm"], strict=False)
    assert not unexpected
    assert set(missing) <= {"linear.weight", "linear.bias"}
    tmodel.aligner.load_state_dict(sd["aligner"])
    jrec, trec = _Rec(), _Rec()
    jstate, jhist = jmodel.fit(jds.TMAlignDataset(fixture_frame()),
                               jds.TMAlignDataset(fixture_frame()),
                               logger=jrec)
    _, thist = tmodel.fit(tds.TMAlignDataset(_rows(fixture_frame())),
                          tds.TMAlignDataset(_rows(fixture_frame())),
                          logger=trec)
    assert [r[:2] for r in trec.rows] == [r[:2] for r in jrec.rows]
    assert sum(r[0] == "train_loss" for r in trec.rows) == 6
    np.testing.assert_allclose([r[2] for r in trec.rows],
                               [r[2] for r in jrec.rows], rtol=1e-4)
    for th, jh in zip(thist, jhist):
        assert th.keys() == jh.keys()
        np.testing.assert_allclose(list(th.values()), list(jh.values()),
                                   rtol=1e-4)
    return tmodel, jstate


@pytest.mark.parametrize("fields", [
    dict(lm_type="bilstm"), dict(layer_type="rnn"),
    dict(lm_type="bilstm", finetune=True)],
    ids=["bilstm", "rnn", "bilstm_finetune"])
def test_fit_trajectory_matches_jax(fields):
    """Each step's loss, each epoch's validation loss and traceback
    statistics agree with the JAX trainer; with ``finetune`` the BiLM's
    trained weights too (rtol 1e-3 / atol 1e-5: six AdamW steps of
    float32 gradients through two libraries' LSTMs)."""
    tmodel, jstate = _bilm_trajectories(**fields)
    if fields.get("lm_type") == "bilstm":
        assert isinstance(tmodel.lm, tlm.BiLM) and tmodel.lm.hidden_dim == 4
    if fields.get("finetune"):
        want = state_dicts_from_jax(jstate)["lm"]
        got = tmodel.lm.state_dict()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-3,
                                       atol=1e-5, err_msg=k)
