"""The port's configuration against the JAX package's: the storage-menu
fields (``dp_bf16_residuals``, ``dp_i16_streams``, ``dp_decode_menu``) and
the menus they resolve to, ``config.json`` in both directions,
``cli.train``'s menu flags, ``load_model`` taking a JAX ``config.json``
that sets a trainer option (``finetune``, ``precision``, ``grad_accum``,
``steps_per_dispatch``) or the BiLM and the RNN head (``lm_type="bilstm"``,
``layer_type="rnn"``, ROADMAP A2), and ``DeepBLASTConfig.from_json``
refusing a JAX ``config.json`` whose options the port does not have (it
used to drop them without a word, ROADMAP.md queue C).  Everything is
exact: no numbers are compared.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from deepblast_torch.cli import common as tcommon
from deepblast_torch.cli import train as ttrain
from deepblast_torch.data.alphabet import ProtT5Tokenizer
from deepblast_torch.models import heads as theads
from deepblast_torch.models import lm as tlm
from deepblast_torch.ops import dp_ref
from deepblast_torch.ops.menu import DTypeMenu
from deepblast_torch.train import trainer as ttrainer
from deepblast_torch.train.checkpoint import load_model, save_config
from deepblast_tpu.train import trainer as jtrainer
from test_train import fixture_frame
import torch_threads  # noqa: F401  (PyTorch threads a worker)

TINY = dict(embedding_dim=16, hidden_dim=16, layers=2, k_size=5,
            vocab_size=32, lm_type="embed", batch_size=4,
            learning_rate=5e-3, epochs=1, max_len=64, pad_multiple=8,
            dropout=0.0)
MENU_FIELDS = ("dp_bf16_residuals", "dp_i16_streams", "dp_decode_menu")


def _menus(model):
    return (model.dp_dtypes, model.dp_decode_dtypes)


def _jax_menus(cfg):
    train = jtrainer.DeepBLAST._dp_dtype_menu(cfg)
    return (train, jtrainer.DeepBLAST._dp_decode_dtype_menu(cfg, train))


@pytest.mark.parametrize("fields", [
    dict(dp_bf16_residuals=False, dp_i16_streams=True,
         dp_decode_menu="fast"),
    dict(dp_bf16_residuals=True, dp_i16_streams=False,
         dp_decode_menu="default", backend="pallas_bm"),
    dict(dp_bf16_residuals="auto", backend="pallas_long"),
])
@pytest.mark.parametrize("source", ["port", "jax"])
def test_config_json_round_trips_the_menu(tmp_path, source, fields):
    """The three menu fields cross ``config.json`` both ways and resolve to
    the JAX trainer's menus (``"auto"`` compared where the two packages
    name the same backend: the JAX package's CPU default is scan)."""
    if source == "port":
        save_config(ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(
            **fields, **TINY), device="cpu"), str(tmp_path))
    else:
        with open(tmp_path / "config.json", "w") as f:
            f.write(jtrainer.DeepBLASTConfig(**fields, **TINY).to_json())
    with open(tmp_path / "config.json") as f:
        raw = f.read()
    jcfg = jtrainer.DeepBLASTConfig.from_json(raw)
    model = load_model(str(tmp_path), device="cpu")
    for k in MENU_FIELDS:
        assert getattr(model.config, k) == getattr(jcfg, k) == \
            fields.get(k, getattr(jcfg, k))
    assert [None if m is None else tuple(m) for m in _menus(model)] == \
        [None if m is None else tuple(m) for m in _jax_menus(jcfg)]
    assert model.aligner.dp_dtypes == model.dp_dtypes


def test_auto_is_on_for_the_default_backend():
    """``"auto"`` resolves by the backend's name: the port's ``None`` is
    ``pallas_bm``, so the default trains with bf16 residuals, as
    ``deepblast-train`` does on the TPU."""
    model = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(**TINY),
                               device="cpu")
    assert model.config.dp_bf16_residuals == "auto"
    assert _menus(model) == (DTypeMenu.make(d="bfloat16"),) * 2
    jcfg = jtrainer.DeepBLASTConfig(backend="pallas_bm", **TINY)
    assert tuple(_menus(model)[0]) == tuple(_jax_menus(jcfg)[0])
    args = tcommon.add_infra_args(tcommon.add_model_args(
        argparse.ArgumentParser())).parse_args(
        ["--train-pairs", "t", "--valid-pairs", "v", "-o", "o"])
    assert args.dp_bf16_residuals == "auto"
    assert tcommon.config_from_args(args).dp_bf16_residuals == "auto"


@pytest.mark.parametrize("field,value", [
    ("finetune", True), ("precision", "bf16"), ("precision", "16"),
    ("grad_accum", 2), ("steps_per_dispatch", 4), ("lm_type", "bilstm"),
    ("layer_type", "rnn")])
def test_load_model_takes_the_trainer_options(tmp_path, field, value):
    """A JAX ``config.json`` that sets one of the trainer options (ROADMAP
    A1), the BiLM or the RNN head (A2) loads, and the value arrives in the
    port's config and model: the JAX trainer's BiLM geometry (hidden
    ``embedding_dim // 4``, ``vocab_size`` ids, the one-hot channel before
    its features) with the ProtT5 tokenizer, as the JAX ``load_model``
    builds them; bidirectional LSTM heads."""
    with open(tmp_path / "config.json", "w") as f:
        f.write(jtrainer.DeepBLASTConfig(**dict(TINY, **{field: value}))
                .to_json())
    model = load_model(str(tmp_path), device="cpu")
    assert getattr(model.config, field) == value
    if field == "precision":
        assert model.aligner.matmul_dtype == \
            ttrainer._PRECISION_DTYPES[value]
    if field == "lm_type":
        lm = model.lm
        assert isinstance(lm, tlm.BiLM) and model.config.bilstm_onehot_channel
        assert (lm.nin, lm.nout, lm.embedding_dim, lm.hidden_dim,
                lm.num_layers) == (32, 31, 4, 4, 2)
        assert isinstance(model.tokenizer, ProtT5Tokenizer)
        assert model.aligner.match_embedding.embed.in_features == 32 + 16
    if field == "layer_type":
        for head in (model.aligner.match_embedding,
                     model.aligner.gap_embedding):
            assert isinstance(head, theads.StackedRNN)
            assert isinstance(head.bwd1, torch.nn.LSTM)


def test_from_json_refuses_a_bilstm_config_without_the_channel_marker():
    """A JAX bilstm ``config.json`` from before the one-hot channel (no
    ``bilstm_onehot_channel``) is refused with the JAX package's message;
    with the marker false the channel-free heads are rebuilt."""
    raw = json.loads(jtrainer.DeepBLASTConfig(
        **dict(TINY, lm_type="bilstm")).to_json())
    raw.pop("bilstm_onehot_channel")
    for cls in (ttrainer.DeepBLASTConfig, jtrainer.DeepBLASTConfig):
        with pytest.raises(ValueError, match="predates the one-hot"):
            cls.from_json(json.dumps(raw))
    raw["bilstm_onehot_channel"] = False
    model = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig.from_json(
        json.dumps(raw)), device="cpu")
    assert model.aligner.match_embedding.embed.in_features == 16


@pytest.mark.parametrize("field,value,item", [
    ("backend", "scan", "queue A item 10"),
])
def test_load_model_refuses_unported_jax_fields(tmp_path, field, value,
                                                item):
    """A JAX ``config.json`` with the option that ``item`` once kept out
    of the port loads with it, and the model aligns through it: under
    ``"backend": "scan"`` the decode walks the scan backend's stream."""
    cfg = dict(TINY, **{field: value})
    with open(tmp_path / "config.json", "w") as f:
        f.write(jtrainer.DeepBLASTConfig(**cfg).to_json())
    model = load_model(str(tmp_path), device="cpu")
    assert getattr(model.config, field) == value
    assert model.aligner.backend == "scan" and model.dp_dtypes is None
    s = model.align("ACDEFGHIKL", "ACDFGHIKLM")
    assert s.count(":") + s.count("1") == 10
    assert s.count(":") + s.count("2") == 10


def test_from_json_drops_only_what_changes_nothing():
    """The JAX fields that change nothing the port computes load (and are
    dropped: ``use_tp_params``); the mesh's ``tp`` and the
    ``visualization_fraction`` are kept; a field neither package writes
    raises."""
    raw = json.loads(jtrainer.DeepBLASTConfig(**TINY).to_json())
    raw.update(visualization_fraction=0.5, tp=2, use_tp_params=True,
               steps_per_dispatch=8)
    cfg = ttrainer.DeepBLASTConfig.from_json(json.dumps(raw))
    assert cfg.embedding_dim == 16 and cfg.dp_bf16_residuals == "auto"
    assert cfg.steps_per_dispatch == 8
    assert cfg.tp == 2 and not hasattr(cfg, "use_tp_params")
    assert cfg.visualization_fraction == 0.5
    raw["bogus"] = 1
    with pytest.raises(ValueError, match="'bogus' is not a field"):
        ttrainer.DeepBLASTConfig.from_json(json.dumps(raw))


def _write_tsv(path, frame):
    with open(path, "w") as f:
        for row in frame.values.tolist():
            f.write("\t".join(str(v) for v in row) + "\n")


@pytest.mark.parametrize("flags,train_menu,decode_menu", [
    (["--dp-i16-streams", "--dp-decode-menu", "fast"],
     DTypeMenu.make(stream="int16", d="bfloat16", e="int16"),
     DTypeMenu.make(d="bfloat16", e="int16")),
    (["--no-dp-bf16-residuals"], None, None),
])
def test_cli_train_takes_the_menu_flags(tmp_path, monkeypatch, flags,
                                        train_menu, decode_menu):
    """``cli.train`` passes the menu flags into config.json; training runs
    the training menu (int16 inputs, float E), ``align`` the decode menu
    (an int16 E stream under "fast") and ``score_pairs`` the training
    menu."""
    train, valid = tmp_path / "train.tsv", tmp_path / "valid.tsv"
    _write_tsv(train, fixture_frame(n_rows=4, seed=1))
    _write_tsv(valid, fixture_frame(n_rows=2, seed=2))
    seen = []
    forward, backward = dp_ref._forward, dp_ref.backward

    def spy_forward(th_s, *a):
        seen.append(("forward", th_s.dtype, a[-1]))
        return forward(th_s, *a)

    def spy_backward(*a, **k):
        out = backward(*a, **k)
        seen.append(("backward", out[0].dtype, k.get("dtypes")))
        return out

    monkeypatch.setattr(dp_ref, "_forward", spy_forward)
    monkeypatch.setattr(dp_ref, "backward", spy_backward)
    out = tmp_path / "out"
    assert ttrain.main([
        "--train-pairs", str(train), "--valid-pairs", str(valid),
        "-o", str(out), "--embedding-dim", "16", "--hidden-dim", "16",
        "--batch-size", "4", "--epochs", "1", "--max-len", "64",
        "--device", "cpu", *flags]) == 0
    # the dispatcher passes None as the all-float32 menu
    tm, dm = (m or DTypeMenu() for m in (train_menu, decode_menu))
    stream = tm.stream_dtype or torch.float32
    assert seen and all(s == ("forward", stream, tm)
                        for s in seen if s[0] == "forward")
    assert all(s == ("backward", torch.float32, tm)
               for s in seen if s[0] == "backward")
    with open(out / "config.json") as f:
        cfg = json.load(f)
    assert {k: cfg[k] for k in MENU_FIELDS} == {
        "dp_bf16_residuals": (False if "--no-dp-bf16-residuals" in flags
                              else "auto"),
        "dp_i16_streams": "--dp-i16-streams" in flags,
        "dp_decode_menu": "fast" if "fast" in flags else "default"}
    model = load_model(str(out), device="cpu")
    assert _menus(model) == (train_menu, decode_menu)
    seen.clear()
    s = model.align("ACDEFGHIKL", "ACDFGHIKLM")
    assert s.count(":") + s.count("1") == 10
    assert seen[-1] == ("backward", dm.e_dtype or torch.float32, dm)
    tok = model.tokenizer("ACDEFG")[0]
    batch = dict(x=tok[None], y=tok[None], x_len=np.array([6]),
                 y_len=np.array([6]))
    seen.clear()
    assert torch.isfinite(model.score_pairs(batch)).all()
    assert seen == [("forward", stream, tm)]
