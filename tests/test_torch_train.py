"""The port's training slice on the CPU against the JAX package: losses,
schedules, datasets and batching, state and ROC helpers, the trainer's
trajectory from the same init on the same data; the checkpointer,
``cli.train`` -> ``load_model`` -> ``align`` (default and
``--backend pallas_long``), ``config.json`` round trips of the backend
(the port's own and the JAX package's), the aligner's eval mode after
``fit``, and the flags the port rejects.

Tolerances: losses atol 1e-12 (fp64, the same reductions); schedules
rtol 1e-6 (triangular: the JAX version computes in float32); datasets
and batches exact; the trajectory rtol 1e-4 (fp32, two libraries' exp,
log and AdamW arithmetic over 6 steps).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepblast_torch.cli import common as tcommon
from deepblast_torch.cli import train as ttrain
from deepblast_torch.data import dataset as tds
from deepblast_torch.data import state_utils as tsu
from deepblast_torch.eval import score as tscore
from deepblast_torch.models.convert import params_from_jax
from deepblast_torch.models.heads import StackedCNN
from deepblast_torch.ops import dp_ref
from deepblast_torch.train import losses as tlosses
from deepblast_torch.train import trainer as ttrainer
from deepblast_torch.train.checkpoint import (Checkpointer, load_model,
                                              save_config)
from deepblast_torch.train.schedules import make_schedule as tsched
from deepblast_tpu.data import dataset as jds
from deepblast_tpu.data import state_utils as jsu
from deepblast_tpu.eval import score as jscore
from deepblast_tpu.train import losses as jlosses
from deepblast_tpu.train import trainer as jtrainer
from deepblast_tpu.train.schedules import make_schedule as jsched
from test_train import fixture_frame
import torch_threads  # noqa: F401  (PyTorch threads a worker)

DATA = os.path.join(os.path.dirname(__file__), "data")
# tests/test_train.py's tiny config with dropout 0, the cosine schedule,
# a clip of 1, and a learning rate of 5e-3: at its 5e-2 the loss doubles
# every step and Adam's sign of near-zero gradients makes fp32 runs of two
# libraries part after three steps
TINY = dict(embedding_dim=16, hidden_dim=16, layers=2, k_size=5,
            vocab_size=32, lm_type="embed", batch_size=4,
            learning_rate=5e-3, epochs=2, scheduler="cosine", max_len=64,
            pad_multiple=8, mask_gaps=True, dropout=0.0, grad_clip=1.0)


def _rows(frame):
    return frame.values.tolist()


@pytest.mark.parametrize("name", ["cross_entropy", "sse", "path"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(0)
    B, N, M = 3, 6, 5
    Yt = (rng.random((B, N, M)) < 0.3).astype(np.float64)
    Yp = rng.random((B, N, M))
    G = rng.random((B, N, M)) < 0.8
    xl, yl = np.array([6, 4, 5]), np.array([5, 3, 2])
    want = jlosses.get_loss(name)(jnp.asarray(Yt), jnp.asarray(Yp),
                                  jnp.asarray(xl), jnp.asarray(yl),
                                  jnp.asarray(G))
    got = tlosses.get_loss(name)(torch.tensor(Yt), torch.tensor(Yp),
                                 torch.tensor(xl), torch.tensor(yl),
                                 torch.tensor(G))
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        tlosses.get_loss("bogus")


@pytest.mark.parametrize("name", ["none", "cosine", "cosine_restarts",
                                  "triangular", "steplr"])
def test_schedules_match_optax(name):
    for epochs, spe in ((8, 10), (3, 7)):
        want = jsched(name, 1e-3, epochs, steps_per_epoch=spe)
        got = tsched(name, 1e-3, epochs, steps_per_epoch=spe)
        np.testing.assert_allclose([got(t) for t in range(50)],
                                   [float(want(t)) for t in range(50)],
                                   rtol=1e-6, atol=0)


def _same_item(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], list):      # ragged: states
            assert len(a[k]) == len(b[k])
            for u, v in zip(a[k], b[k]):
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v),
                                              err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("source", ["fixture", "tab"])
def test_dataset_and_batches_match_jax(source):
    if source == "fixture":
        jset = jds.TMAlignDataset(fixture_frame(n_rows=10, seed=4),
                                  construct_paths=True)
        tset = tds.TMAlignDataset(_rows(fixture_frame(n_rows=10, seed=4)),
                                  construct_paths=True)
    else:
        path = os.path.join(DATA, "test_tm_align.tab")
        jset = jds.TMAlignDataset(path, tm_threshold=0.3)
        tset = tds.TMAlignDataset(path, tm_threshold=0.3)
    assert len(tset) == len(jset) > 0
    np.testing.assert_array_equal(tset.lengths(), jset.lengths())
    for i in range(len(jset)):
        _same_item(tset[i], jset[i])
    for shuffle, seed in ((True, 3), (False, 0)):
        jb = list(jds.make_batches(jset, 3, shuffle=shuffle, seed=seed,
                                   pad_multiple=8))
        tb = list(tds.make_batches(tset, 3, shuffle=shuffle, seed=seed,
                                   pad_multiple=8))
        assert len(tb) == len(jb)
        for a, b in zip(tb, jb):
            _same_item(a, b)


@pytest.mark.parametrize("st", ["::1::2:", "11:::22:1", ":2:.:1:", "::::"])
def test_state_and_roc_helpers_match_jax(st):
    states = [tsu.tmstate_f(c) for c in st]
    assert states == [jsu.tmstate_f(c) for c in st]
    assert tsu.states2edges(states) == jsu.states2edges(states)
    np.testing.assert_array_equal(tsu.states2matrix(states),
                                  jsu.states2matrix(states))
    np.testing.assert_array_equal(tsu.gap_mask(st), jsu.gap_mask(st))
    np.testing.assert_array_equal(
        tsu.path_distance_matrix(tsu.states2edges(states)),
        jsu.path_distance_matrix(jsu.states2edges(states)))
    pred = [tsu.m] * (len(states) - 1) + [tsu.x]
    te = tscore.filter_gaps(states, tsu.states2edges(states))
    pe = tscore.filter_gaps(pred, tsu.states2edges(pred))
    assert te == jscore.filter_gaps(states, jsu.states2edges(states))
    assert tscore.roc_edges(te, pe) == jscore.roc_edges(te, pe)
    assert tscore.ROC_COLUMNS == jscore.ROC_COLUMNS


class _Rec:
    """A logger that records what the trainers log."""

    def __init__(self):
        self.rows = []

    def log_scalar(self, tag, value, step):
        self.rows.append((tag, int(step), float(value)))

    def log_figure(self, *a, **k):
        pass

    def log_text(self, *a, **k):
        pass


def _fit_trajectories(port_bf16, jax_bf16, **fields):
    """Fit the port and the JAX trainer (scan backend) from the same init
    (the JAX init carried across) on the same batches, ``TINY`` with
    ``fields`` (with the path loss, on datasets that construct the path
    targets); returns each one's logged rows and history."""
    cfg = dict(TINY, **fields)
    paths = cfg["loss"] == "path" if "loss" in cfg else False
    jmodel = jtrainer.DeepBLAST(jtrainer.DeepBLASTConfig(
        backend="scan", dp_bf16_residuals=jax_bf16, **cfg))
    jmodel.state = jmodel.init()
    tmodel = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(
        dp_bf16_residuals=port_bf16, **cfg), device="cpu")
    # copied before the JAX fit, which donates (deletes) its state
    tmodel.lm.load_state_dict(params_from_jax(jmodel.state.lm_params))
    tmodel.aligner.load_state_dict(
        params_from_jax(jmodel.state.params["aligner"]))
    jrec = _Rec()
    _, jhist = jmodel.fit(
        jds.TMAlignDataset(fixture_frame(), construct_paths=paths),
        jds.TMAlignDataset(fixture_frame(), construct_paths=paths),
        logger=jrec)
    trec = _Rec()
    state, thist = tmodel.fit(
        tds.TMAlignDataset(_rows(fixture_frame()), construct_paths=paths),
        tds.TMAlignDataset(_rows(fixture_frame()), construct_paths=paths),
        logger=trec)
    assert state["step"] == 6 and tmodel.step == 6
    return (trec.rows, thist), (jrec.rows, jhist)


_COUNT_STATS = ("val_tp", "val_fp", "val_fn")


def _same_trajectory(port, jax_, rtol, count_atol=0.0, rate_atol=0.0):
    """Losses at ``rtol``; the validation traceback statistics at ``rtol``
    plus ``count_atol`` (the edge counts ``val_tp``/``val_fp``/``val_fn``)
    or ``rate_atol`` (the other ``val_*``, rates in [0, 1])."""
    def atol(key):
        if key in _COUNT_STATS:
            return count_atol
        return rate_atol if key.startswith("val_") else 0.0

    (trows, thist), (jrows, jhist) = port, jax_
    assert [r[:2] for r in trows] == [r[:2] for r in jrows]
    assert sum(r[0] == "train_loss" for r in trows) == 6
    for tr, jr in zip(trows, jrows):
        np.testing.assert_allclose(tr[2], jr[2], rtol=rtol, atol=atol(tr[0]),
                                   err_msg=str(tr[:2]))
    assert [h.keys() for h in thist] == [h.keys() for h in jhist]
    for th, jh in zip(thist, jhist):
        for k in th:
            np.testing.assert_allclose(th[k], jh[k], rtol=rtol, atol=atol(k),
                                       err_msg=k)


def test_fit_trajectory_matches_jax():
    """fp32 residuals (``dp_bf16_residuals=False``; the port's default is
    "auto", on for its default backend): each step's train loss, each
    epoch's validation loss and the validation traceback stats agree with
    the JAX trainer's scan backend (where "auto" is off)."""
    _same_trajectory(*_fit_trajectories(False, "auto"), rtol=1e-4)


@pytest.mark.parametrize("fields", [
    dict(alignment_mode="smith-waterman"), dict(operator="sparsemax"),
    dict(loss="sse"), dict(loss="path"), dict(mask_gaps=False),
    dict(alignment_mode="smith-waterman", operator="hardmax", loss="path")],
    ids=["sw", "sparsemax", "sse", "path", "no_gap_mask",
         "sw_hardmax_path"])
def test_fit_trajectory_variants_match_jax(fields):
    """The trajectory of ``test_fit_trajectory_matches_jax`` in the other
    modes, operators and losses, and without the gap mask (the path loss
    on path-distance targets): rtol 1e-4 (read, the largest relative
    difference: 1.2e-5, sparsemax)."""
    _same_trajectory(*_fit_trajectories(False, "auto", **fields), rtol=1e-4)


def test_fit_trajectory_bf16_residuals_matches_jax():
    """The port's default, bf16 difference residuals ("auto" on the
    default pallas_bm backend), against the JAX trainer's scan backend
    with ``dp_bf16_residuals=True``: the scan oracle's emulation rebuilds
    Q and Qd from the same bf16-rounded differences as the pallas_bm
    reverse passes.  The scan forms the differences as
    ``(A + shr(V)) - (A + V)`` where the residual passes store
    ``shr(V) - V``, so an fp32 last bit now and then moves a bf16 rounding
    (2^-8 relative) of one difference.  The losses still agree to rtol
    1e-4 (~1e-5 absolute measured); such a moved rounding can flip one
    near-tie step of a greedy traceback, which moves one edge of one of
    the 12 validation pairs: a count mean (tp, fp, fn) by 1/12, held to
    atol 1/12 + 1e-9, and a rate mean by about 1/(12 x 17 edges), held to
    atol 0.01 (0.0056 measured)."""
    port, jax_ = _fit_trajectories("auto", True)
    _same_trajectory(port, jax_, rtol=1e-4, count_atol=1 / 12 + 1e-9,
                     rate_atol=0.01)


def test_nan_loss_raises():
    model = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(**TINY),
                               device="cpu").init()
    with pytest.raises(FloatingPointError, match="NaN training loss"):
        model._consume_loss(((torch.tensor(float("nan")), None), 3), [],
                            None)


def test_dropout_uses_the_callers_generator():
    head = StackedCNN(8, 8, layers=2, dropout=0.5)
    x = torch.randn((2, 7, 8), generator=torch.Generator().manual_seed(0))
    head.train()
    a = head(x, generator=torch.Generator().manual_seed(5))
    b = head(x, generator=torch.Generator().manual_seed(5))
    c = head(x, generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    head.eval()
    full = head(x)
    kept = a != 0
    torch.testing.assert_close(a[kept], 2 * full[kept])
    assert torch.equal(head(x, generator=torch.Generator().manual_seed(5)),
                       full)


def _state(step, value):
    return {"step": step, "aligner": {"w": torch.full((2,), float(value))},
            "optimizer": None, "scheduler": None}


def test_checkpointer_keeps_the_best(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), keep=3)
    for step, v in zip(range(1, 6), (5.0, 3.0, 4.0, 1.0, 2.0)):
        ck.save(_state(step, v), {"validation_loss": v, "epoch": step})
    assert ck.steps() == [(1.0, 4), (2.0, 5), (3.0, 2)]
    assert sorted(os.listdir(tmp_path / "ck")) == ["2", "4", "5"]
    assert ck.restore()["aligner"]["w"][0] == 1.0
    assert ck.restore(step=2)["step"] == 2
    other = Checkpointer(str(tmp_path / "tl"), keep=1)
    other.save(_state(1, 9.0), {"train_loss": 9.0})
    other.save(_state(2, 7.0), {"train_loss": 7.0})
    assert other.best_step() == 2


def _write_tsv(path, frame):
    with open(path, "w") as f:
        for row in _rows(frame):
            f.write("\t".join(str(v) for v in row) + "\n")


def test_cli_train_then_load_model_aligns(tmp_path):
    train, valid = tmp_path / "train.tsv", tmp_path / "valid.tsv"
    _write_tsv(train, fixture_frame(n_rows=12, seed=1))
    _write_tsv(valid, fixture_frame(n_rows=4, seed=2))
    out = tmp_path / "out"
    assert ttrain.main([
        "--train-pairs", str(train), "--valid-pairs", str(valid),
        "-o", str(out), "--embedding-dim", "16", "--hidden-dim", "16",
        "--batch-size", "4", "--epochs", "3", "--max-len", "64",
        "--learning-rate", "5e-3", "--device", "cpu"]) == 0
    with open(out / "config.json") as f:
        cfg = json.load(f)
    assert cfg["epochs"] == 3 and cfg["dropout"] == 0.5
    kept = Checkpointer(str(out / "checkpoints")).steps()
    assert 1 <= len(kept) <= 3
    model = load_model(str(out), device="cpu")
    best = Checkpointer(str(out / "checkpoints")).restore()
    assert model.step == best["step"]
    for k, v in best["aligner"].items():
        assert torch.equal(model.aligner.state_dict()[k], v)
    for x, y in (("ACDEFGHIKL", "ACDFGHIKLM"), ("MKTAYIAK", "MKTAYK")):
        s = model.align(x, y)
        assert s.count(":") + s.count("1") == len(x)
        assert s.count(":") + s.count("2") == len(y)
    logs = [d for d in os.listdir(out) if d.startswith("logdir_")]
    with open(out / logs[0] / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert {"train_loss", "validation_loss", "val_ppv"} <= \
        {r["tag"] for r in records}
    walls = [r["wall_time"] for r in records]
    assert walls == sorted(walls)


@pytest.mark.parametrize("flag", [["--visualization-fraction", "0.1"],
                                  ["--backend", "scan"]])
def test_cli_train_rejects_unported_flags(tmp_path, monkeypatch, flag):
    """The last two flags the port once refused train and land in
    config.json: ``--visualization-fraction`` (figures and events:
    ``tests/test_torch_visualization.py``) and ``--backend scan``, whose
    steps run the plain Q-stream passes and none of the residual ones
    (``--pretrain-path``, ``--layer-type rnn`` and ``--lm-type bilstm``:
    ``tests/test_torch_bilm.py``, ``tests/test_torch_lm_convert.py``;
    ``--nodes``, ``--tp``, ``--coordinator`` and ``--process-id``:
    ``test_cli_train_takes_the_distributed_flags``)."""
    train, valid = tmp_path / "train.tsv", tmp_path / "valid.tsv"
    _write_tsv(train, fixture_frame(n_rows=4, seed=1))
    _write_tsv(valid, fixture_frame(n_rows=4, seed=2))
    q = _count_calls(monkeypatch, dp_ref, "adjoint_forward_q")
    d = _count_calls(monkeypatch, dp_ref, "adjoint_forward")
    out = tmp_path / "out"
    assert ttrain.main([
        "--train-pairs", str(train), "--valid-pairs", str(valid),
        "-o", str(out), "--embedding-dim", "16", "--hidden-dim", "16",
        "--batch-size", "4", "--epochs", "1", "--max-len", "64",
        "--device", "cpu", *flag]) == 0
    with open(out / "config.json") as f:
        cfg = json.load(f)
    key = flag[0][2:].replace("-", "_")
    assert cfg[key] == (float(flag[1]) if key.endswith("fraction")
                        else flag[1])
    assert (len(q), len(d)) == ((1, 0) if flag[1] == "scan" else (0, 1))


class _Joined(Exception):
    pass


@pytest.mark.parametrize("flag,key,value", [
    (["--nodes", "2"], "world_size", 2),
    (["--tp", "2"], "tp", 2),
    (["--coordinator", "localhost:1"], "init_method", "tcp://localhost:1"),
    (["--process-id", "1"], "rank", 1)])
def test_cli_train_takes_the_distributed_flags(tmp_path, monkeypatch, flag,
                                               key, value):
    """``--nodes``, ``--coordinator`` and ``--process-id`` reach
    ``init_process_group`` (through ``initialize_distributed``, with the
    others set to a coordinator's defaults: 2 processes, rank 0), and
    ``--tp`` the config (``deepblast_tpu/cli/train.py:22-46``); the process
    group is monkeypatched, so nothing is joined."""
    seen = {}

    def join(backend, **kw):
        seen.update(kw, backend=backend)
        raise _Joined

    monkeypatch.setattr(torch.distributed, "init_process_group", join)
    argv = ["--train-pairs", "t", "--valid-pairs", "v", "-o", str(tmp_path),
            "--device", "cpu", "--coordinator", "127.0.0.1:29500",
            "--nodes", "2", "--process-id", "0", *flag]
    config = tcommon.config_from_args(ttrain.parse_args(argv))
    with pytest.raises(_Joined):
        ttrain.main(argv)
    assert seen["backend"] == ("nccl" if torch.cuda.is_available()
                               else "gloo")
    got = config.tp if key == "tp" else seen[key]
    assert got == value


def test_cli_train_needs_cuda_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--train-pairs", "t", "--valid-pairs", "v",
                     "-o", str(tmp_path)])


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_cli_train_pallas_long_then_load_model_aligns(tmp_path, monkeypatch):
    """``--backend pallas_long`` trains through the Q passes, lands in
    config.json, and the loaded model aligns and scores through them."""
    train, valid = tmp_path / "train.tsv", tmp_path / "valid.tsv"
    _write_tsv(train, fixture_frame(n_rows=8, seed=1))
    _write_tsv(valid, fixture_frame(n_rows=4, seed=2))
    out = tmp_path / "out"
    calls = _count_calls(monkeypatch, dp_ref, "adjoint_backward_q")
    assert ttrain.main([
        "--train-pairs", str(train), "--valid-pairs", str(valid),
        "-o", str(out), "--embedding-dim", "16", "--hidden-dim", "16",
        "--batch-size", "4", "--epochs", "2", "--max-len", "64",
        "--learning-rate", "5e-3", "--device", "cpu",
        "--backend", "pallas_long"]) == 0
    assert len(calls) == 4      # 2 steps x 2 epochs, each one Q gradient
    with open(out / "config.json") as f:
        assert json.load(f)["backend"] == "pallas_long"
    model = load_model(str(out), device="cpu")
    assert model.aligner.backend == "pallas_long"
    fwd = _count_calls(monkeypatch, dp_ref, "forward_q")
    for x, y in (("ACDEFGHIKL", "ACDFGHIKLM"), ("MKTAYIAK", "MKTAYK")):
        s = model.align(x, y)
        assert s.count(":") + s.count("1") == len(x)
        assert s.count(":") + s.count("2") == len(y)
    tok = [model.tokenizer(q)[0] for q in ("ACDEFG", "MKTAY")]
    batch = dict(x=np.stack([np.pad(tok[0], (0, 2)), np.pad(tok[1], (0, 3))]),
                 y=np.stack([np.pad(tok[1], (0, 3)), np.pad(tok[0], (0, 2))]),
                 x_len=np.array([6, 5]), y_len=np.array([5, 6]))
    assert torch.isfinite(model.score_pairs(batch)).all()
    assert len(fwd) == 3


@pytest.mark.parametrize("source", ["port", "jax"])
def test_config_json_carries_the_backend(tmp_path, monkeypatch, source):
    """The backend round-trips through config.json, and a JAX package's
    config.json with ``"backend": "pallas_long"`` loads into the port and
    selects the Q passes."""
    if source == "port":
        save_config(ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(
            backend="pallas_long", **TINY), device="cpu"), str(tmp_path))
    else:
        os.makedirs(tmp_path, exist_ok=True)
        with open(tmp_path / "config.json", "w") as f:
            f.write(jtrainer.DeepBLASTConfig(backend="pallas_long",
                                             **TINY).to_json())
    model = load_model(str(tmp_path), device="cpu")
    assert model.config.backend == model.aligner.backend == "pallas_long"
    calls = _count_calls(monkeypatch, dp_ref, "backward_q")
    model.align("ACDEFGHIKL", "ACDFGHIKLM")
    assert calls == ["backward_q"]


def test_align_and_score_pairs_run_in_eval_mode():
    """After ``fit`` without a validation set the aligner was left in
    train mode, so ``align`` and ``score_pairs`` drew dropout masks; the
    JAX package applies the aligner deterministically there."""
    model = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(
        **dict(TINY, dropout=0.5, epochs=1)), device="cpu").init()
    model.fit(tds.TMAlignDataset(_rows(fixture_frame(n_rows=4, seed=1))))
    assert model.aligner.training
    tok = model.tokenizer("ACDEFGHIKLMNPQ")[0]
    batch = dict(x=tok[None], y=tok[None], x_len=np.array([len(tok)]),
                 y_len=np.array([len(tok)]))
    first = model.score_pairs(batch)
    assert not model.aligner.training
    model.aligner.train()
    assert torch.equal(model.score_pairs(batch), first)
    model.aligner.train()
    x, y = "ACDEFGHIKLMNPQ", "ACDFGHIKLMNPQR"
    assert model.align(x, y) == model.align(x, y)
    assert not model.aligner.training
