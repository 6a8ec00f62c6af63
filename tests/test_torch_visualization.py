"""The port's TensorBoard logging and validation figures against the JAX
package's (``utils/logging.py``, ``eval/score.alignment_visualization``,
``DeepBLAST._log_visualizations``).

* ``fit`` at ``visualization_fraction=1.0`` in both packages, each with
  its ``MetricsLogger`` (TensorBoard on): the event files read back with
  ``EventAccumulator`` hold the same scalars (tags and steps exactly,
  values at the trajectory's rtol 1e-4), the same text records (exactly)
  and figures under the same ``alignment-matrix/{b}`` tags and steps; the
  JSONL text records agree too.
* The port's event files alone (``metrics.jsonl`` removed) through both
  packages' ``tensorboard_to_csv``: the same bytes.
* With matplotlib unimportable ``fit`` completes and logs no figure (nor
  the text of a pair whose figure failed, as in JAX).
* The draws: pairs kept where ``random.Random(seed)`` draws at most the
  fraction, two pairs at most, figure then text; none off rank 0.
* ``alignment_visualization`` draws the JAX panels; the logger writes
  nothing off rank 0 and closes a figure it cannot write.

The port runs its default backend with float32 residuals against the
JAX trainer's scan, as ``test_fit_trajectory_matches_jax``.
"""

import json
import os
import random
import sys

import matplotlib
import numpy as np
import pytest

from deepblast_torch.data import dataset as tds
from deepblast_torch.eval import score as tscore
from deepblast_torch.models.convert import params_from_jax
from deepblast_torch.parallel import mesh as tmesh
from deepblast_torch.train import trainer as ttrainer
from deepblast_torch.utils import logging as tlogging
from deepblast_tpu.data import dataset as jds
from deepblast_tpu.eval import score as jscore
from deepblast_tpu.train import trainer as jtrainer
from deepblast_tpu.utils import logging as jlogging
from test_torch_train import TINY, _rows
from test_train import fixture_frame
import torch_threads  # noqa: F401  (PyTorch threads a worker)

matplotlib.use("Agg")
from tensorboard.backend.event_processing.event_accumulator import (  # noqa
    EventAccumulator)

FIGURES = {"alignment-matrix/0", "alignment-matrix/1"}


def _port(**fields):
    return ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(
        dp_bf16_residuals=False, **dict(TINY, **fields)), device="cpu")


def _port_fit(model, logger):
    data = tds.TMAlignDataset(_rows(fixture_frame()))
    return model.fit(data, data, logger=logger)


@pytest.fixture(scope="module")
def logdirs(tmp_path_factory):
    """The logdirs of a JAX and a port ``fit`` at fraction 1.0 from the
    same init on the same batches."""
    root = str(tmp_path_factory.mktemp("logs"))
    jmodel = jtrainer.DeepBLAST(jtrainer.DeepBLASTConfig(
        backend="scan", visualization_fraction=1.0, **TINY))
    jmodel.state = jmodel.init()
    tmodel = _port(visualization_fraction=1.0)
    tmodel.lm.load_state_dict(params_from_jax(jmodel.state.lm_params))
    tmodel.aligner.load_state_dict(
        params_from_jax(jmodel.state.params["aligner"]))
    jlog = jlogging.MetricsLogger(root, "jax")
    data = jds.TMAlignDataset(fixture_frame())
    jmodel.fit(data, data, logger=jlog)
    jlog.close()
    tlog = tlogging.MetricsLogger(root, "port")
    _port_fit(tmodel, tlog)
    tlog.close()
    return jlog.path, tlog.path


def _events(path):
    acc = EventAccumulator(path, size_guidance={"images": 0, "tensors": 0,
                                                "scalars": 0})
    acc.Reload()
    tags = acc.Tags()
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)]
               for t in tags["scalars"]}
    texts = {t: [(e.step, e.tensor_proto.string_val[0].decode())
                 for e in acc.Tensors(t)] for t in tags["tensors"]}
    images = {t: [e.step for e in acc.Images(t)] for t in tags["images"]}
    return scalars, texts, images


def _jsonl_texts(path):
    with open(os.path.join(path, "metrics.jsonl")) as f:
        return [(r["tag"], r["step"], r["text"])
                for r in map(json.loads, f) if "text" in r]


def test_fit_writes_the_jax_records_and_figures(logdirs):
    (js, jt, ji), (ts, tt, ti) = (_events(p) for p in logdirs)
    assert ts.keys() == js.keys() and "train_loss" in ts
    for tag in ts:
        assert [s for s, _ in ts[tag]] == [s for s, _ in js[tag]], tag
        np.testing.assert_allclose([v for _, v in ts[tag]],
                                   [v for _, v in js[tag]], rtol=1e-4,
                                   err_msg=tag)
    assert set(tt) == {"alignment/0/text_summary",
                       "alignment/1/text_summary"}
    assert tt == jt
    assert set(ti) == FIGURES and ti == ji
    assert [s for s in ti["alignment-matrix/0"]] == [3, 6]   # each epoch
    assert _jsonl_texts(logdirs[1]) == _jsonl_texts(logdirs[0])
    assert tt["alignment/0/text_summary"][0][1].startswith("tp: ")


def test_event_files_alone_convert_as_jax(logdirs, tmp_path):
    _, port = logdirs
    events = tmp_path / "events"
    os.makedirs(events)
    for name in os.listdir(port):
        if name.startswith("events.out.tfevents"):
            with open(os.path.join(port, name), "rb") as f:
                (events / name).write_bytes(f.read())
    got, want = tmp_path / "t.csv", tmp_path / "j.csv"
    for pattern in (None, "val_"):
        rows = tlogging.tensorboard_to_csv(str(events), str(got), pattern)
        df = jlogging.tensorboard_to_csv(str(events), str(want), pattern)
        assert got.read_bytes() == want.read_bytes()
        assert len(rows) == len(df) > 0


class _Figures:
    """A logger that keeps the tags of what the trainer logs and closes
    each figure."""

    def __init__(self):
        self.tags = []

    def log_scalar(self, tag, value, step):
        pass

    def log_text(self, tag, text, step):
        self.tags.append(tag)

    def log_figure(self, tag, fig, step):
        import matplotlib.pyplot as plt
        plt.close(fig)
        self.tags.append(tag)


def test_fit_without_matplotlib_completes(monkeypatch, tmp_path):
    """Visualisation never stops training: with matplotlib unimportable
    every pair's figure fails, and the pair (figure and text) is
    skipped."""
    for name in [m for m in sys.modules if m.startswith("matplotlib")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    log = tlogging.MetricsLogger(str(tmp_path), "nompl")
    _, history = _port_fit(_port(epochs=1, visualization_fraction=1.0), log)
    log.close()
    assert len(history) == 1
    scalars, texts, images = _events(log.path)
    assert "validation_loss" in scalars and not texts and not images


@pytest.mark.parametrize("fraction,seed", [(0.5, 0), (0.5, 4), (0.0, 0)])
def test_draws_follow_the_seed(fraction, seed):
    rng = random.Random(seed)
    want = []
    for _ in range(2):          # two epochs, two pairs each
        for b in range(2):
            if rng.random() <= fraction:
                want += [f"alignment-matrix/{b}", f"alignment/{b}"]
    rec = _Figures()
    _port_fit(_port(visualization_fraction=fraction, seed=seed), rec)
    assert rec.tags == want


def test_only_rank_0_draws(monkeypatch):
    monkeypatch.setattr(tmesh, "is_writer", lambda: False)
    rec = _Figures()
    _port_fit(_port(epochs=1, visualization_fraction=1.0), rec)
    assert rec.tags == []


def test_alignment_visualization_matches_jax():
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(0)
    mats = [rng.random((12, 9)) for _ in range(4)]
    (tfig, tax), (jfig, jax_) = (mod.alignment_visualization(*mats, 10, 7)
                                 for mod in (tscore, jscore))
    assert len(tax) == len(jax_) == 4
    for ta, ja in zip(tax, jax_):
        assert ta.get_title() == ja.get_title()
        np.testing.assert_array_equal(ta.images[0].get_array(),
                                      ja.images[0].get_array())
        assert ta.images[0].get_array().shape == (10, 7)
    assert len(tfig.axes) == len(jfig.axes) == 7     # three colour bars
    plt.close(tfig)
    plt.close(jfig)


def test_logger_writes_only_on_rank_0(monkeypatch, tmp_path):
    import matplotlib.pyplot as plt
    log = tlogging.MetricsLogger(str(tmp_path), "a", tensorboard=False)
    log.log_text("alignment/0", "text", 3)
    fig = plt.figure()
    log.log_figure("alignment-matrix/0", fig, 3)
    assert not plt.fignum_exists(fig.number)
    log.close()
    with open(os.path.join(log.path, "metrics.jsonl")) as f:
        rec = json.loads(f.readline())
    assert rec["tag"] == "alignment/0" and rec["text"] == "text"
    assert rec["step"] == 3 and rec["wall_time"] > 0
    monkeypatch.setattr(tlogging, "is_writer", lambda: False)
    log = tlogging.MetricsLogger(str(tmp_path), "b")
    log.log_scalar("train_loss", 1.0, 0)
    log.log_text("alignment/0", "text", 0)
    fig = plt.figure()
    log.log_figure("alignment-matrix/0", fig, 0)
    log.close()
    assert log.path is None and not os.path.exists(tmp_path / "b")
    assert not plt.fignum_exists(fig.number)
