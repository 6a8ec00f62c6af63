"""Offline LM weight loading of the port (ROADMAP A8) on the CPU against
the JAX package:

* ``deepblast-tpu-lm/1`` artifacts (a ProtT5 and a Bepler BiLM, float32
  and bf16 storage) written by the JAX ``save_converted_lm`` load in the
  port bit for bit, and the port's load in JAX bit for bit; both write
  the same arrays and manifest;
* ``convert_checkpoint`` and ``load_prot_t5`` on seeded tiny
  ``transformers.T5EncoderModel``s built here (relu and gated-gelu, as
  ``tests/test_t5_parity.py:30-46``): the port's artifact equals the JAX
  package's, and the port's encoder on the converted weights equals the
  JAX encoder and the HF model;
* ``detect_kind``, ``infer_t5_config``, ``validate_hf_t5_state_dict`` and
  the key manifests on whole and damaged state dicts, as JAX's;
* ``cli.convert_lm``, ``build_model`` with a BiLM artifact (the Uniprot21
  tokenizer, the widths from the artifact) and with a raw HF directory,
  ``cli.train --pretrain-path`` -> ``load_model`` (the LM and tokenizer it
  was trained with), and ``load_model`` refusing a JAX config.json of a
  model trained from a BiLM artifact, whose LM neither package can rebuild.

Tolerances: artifacts, converted weights and manifests exactly; the T5
encoders in float32 to atol 1e-5 on outputs of unit scale (the sums of
two libraries; read ~1e-6), as ``tests/test_t5_parity.py``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from deepblast_torch.cli import common as tcommon
from deepblast_torch.cli import convert_lm as tconvert_cli
from deepblast_torch.cli import train as ttrain
from deepblast_torch.data.alphabet import (ProtT5Tokenizer,
                                           UniprotPairTokenizer)
from deepblast_torch.models import convert as tconvert
from deepblast_torch.models import lm as tlm
from deepblast_torch.train import trainer as ttrainer
from deepblast_torch.train.checkpoint import load_model
from deepblast_tpu.cli import common as jcommon
from deepblast_tpu.models import convert as jconvert
from deepblast_tpu.models import lm as jlm
from deepblast_tpu.train import trainer as jtrainer
from test_torch_train import _write_tsv
from test_train import fixture_frame
import torch_threads  # noqa: F401  (PyTorch threads a worker)

TINY_T5 = dict(vocab_size=32, d_model=32, d_kv=8, d_ff=64, num_layers=2,
               num_heads=4, relative_attention_num_buckets=8)
BILM = dict(nin=22, nout=21, embedding_dim=21, hidden_dim=8, num_layers=2)


def _fake_sd(key_shapes, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.tensor(rng.standard_normal(s).astype(np.float32) * 0.1)
            for k, s in key_shapes.items()}


def _t5_sd(ff="relu", seed=0):
    cfg = tlm.T5Config(feed_forward_proj=ff, **TINY_T5)
    return _fake_sd(tconvert.hf_t5_encoder_key_shapes(cfg), seed), cfg


def _bilm_sd(seed=0):
    return _fake_sd(tconvert.bilm_key_shapes(**BILM), seed)


def _same_sd(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _npz(directory):
    with np.load(os.path.join(directory, "params.npz")) as d:
        return {k: d[k] for k in d.files}


def _manifest(directory):
    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("kind", ["prot_t5", "bilstm"])
def test_artifacts_cross_both_ways(tmp_path, kind, dtype):
    """One flax tree saved by each package: the same arrays (bf16 as the
    same uint16 bits, rounded to nearest even) and manifest; each package's
    artifact loads in the port to the weights the JAX loader gives,
    carried across, bit for bit."""
    if kind == "prot_t5":
        sd, cfg = _t5_sd()
        tree = tconvert.hf_t5_encoder_tree(sd, cfg)
        jtree = jlm.convert_hf_t5_encoder(sd, jlm.T5Config(**TINY_T5))
        config = dict(TINY_T5, d_kv=8, feed_forward_proj="relu")
    else:
        sd = _bilm_sd()
        tree = tconvert.bepler_bilm_tree(sd, 2)
        jtree = jlm.convert_bepler_bilm(sd, num_layers=2)
        config = BILM
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jconvert.save_converted_lm(jdir, kind, jtree, config, dtype=dtype)
    tconvert.save_converted_lm(tdir, kind, tree, config, dtype=dtype)
    assert _manifest(jdir) == _manifest(tdir)
    ja, ta = _npz(jdir), _npz(tdir)
    assert ja.keys() == ta.keys()
    assert all(k.endswith("::bf16") == (dtype is not None) for k in ja)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype
        np.testing.assert_array_equal(ja[k], ta[k], err_msg=k)
    for directory in (jdir, tdir):
        module, got = tconvert.load_converted_lm(directory)
        jmodule, jparams = jconvert.load_converted_lm(directory)
        _same_sd(got, tconvert.params_from_jax(jparams))
        assert type(module).__name__ == type(jmodule).__name__
        module.load_state_dict(got)
    assert tconvert.is_converted_lm(tdir) and jconvert.is_converted_lm(tdir)
    assert not tconvert.is_converted_lm(str(tmp_path))


def _hf_dir(tmp_path, ff, seed=0):
    hf_cfg = transformers.T5Config(
        feed_forward_proj=ff, dropout_rate=0.0, is_encoder_decoder=False,
        use_cache=False, **TINY_T5)
    torch.manual_seed(seed)
    model = transformers.T5EncoderModel(hf_cfg).eval()
    d = tmp_path / f"hf_{ff}"
    d.mkdir()
    torch.save(model.state_dict(), str(d / "pytorch_model.bin"))
    return model, str(d)


@pytest.mark.parametrize("ff", ["relu", "gated-gelu"])
def test_convert_checkpoint_and_load_prot_t5_match_jax(tmp_path, ff):
    """A real (seeded, tiny) HF ``T5EncoderModel``: both packages'
    ``convert_checkpoint`` write the same artifact; the port's
    ``load_prot_t5`` infers its geometry and gives the artifact's weights;
    its encoder equals the JAX encoder on the JAX conversion, and the HF
    model, at true positions."""
    hf, d = _hf_dir(tmp_path, ff)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tm = tconvert.convert_checkpoint(d, tdir)
    jm = jconvert.convert_checkpoint(d, jdir)
    assert tm == jm and tm["kind"] == "prot_t5"
    ta, ja = _npz(tdir), _npz(jdir)
    assert ta.keys() == ja.keys()
    for k in ta:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    enc, sd = tlm.load_prot_t5(d)
    assert enc.cfg == tlm.T5Config(feed_forward_proj=ff, **TINY_T5)
    _same_sd(sd, tconvert.load_converted_lm(tdir)[1])
    enc.load_state_dict(sd)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 32, (3, 17))
    lengths = np.array([17, 11, 5])
    mask = np.arange(17)[None, :] < lengths[:, None]
    with torch.no_grad():
        got = enc(torch.tensor(tokens), torch.tensor(mask)).numpy()
        ref = hf(input_ids=torch.tensor(tokens),
                 attention_mask=torch.tensor(mask.astype(np.int64)))
    ref = ref.last_hidden_state.numpy() * mask[..., None]
    jcfg = jlm.T5Config(feed_forward_proj=ff, **TINY_T5)
    want = np.asarray(jlm.T5Encoder(jcfg).apply(
        jlm.convert_hf_t5_encoder(hf.state_dict(), jcfg),
        jnp.asarray(tokens), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    _same_sd(tlm.convert_hf_t5_encoder(hf.state_dict(), enc.cfg), sd)


def test_layout_checks_match_jax():
    """The key manifests, ``infer_t5_config``, ``validate_hf_t5_state_dict``
    on a whole, a truncated, a mis-shaped and an extended state dict, and
    ``detect_kind`` (with its refusal), as the JAX package's."""
    xl_t, xl_j = tlm.T5Config.prot_t5_xl(), jlm.T5Config.prot_t5_xl()
    assert tconvert.hf_t5_encoder_key_shapes(xl_t) == \
        jconvert.hf_t5_encoder_key_shapes(xl_j)
    assert sum(int(np.prod(s)) for s in
               tconvert.hf_t5_encoder_key_shapes(xl_t).values()) == \
        1_208_141_824
    assert tconvert.bilm_key_shapes() == jconvert.bilm_key_shapes()
    for ff in ("relu", "gated-gelu"):
        sd, cfg = _t5_sd(ff)
        inf, jinf = tconvert.infer_t5_config(sd), \
            jconvert.infer_t5_config(sd)
        assert inf == cfg
        assert {k: getattr(jinf, k) for k in TINY_T5} == \
            {k: getattr(inf, k) for k in TINY_T5}
        jcfg = jlm.T5Config(feed_forward_proj=ff, **TINY_T5)
        short = dict(sd)
        short.pop("encoder.final_layer_norm.weight")
        bad = dict(sd, **{"shared.weight": sd["shared.weight"][:, :-1]})
        extra = dict(sd, **{"lm_head.weight": torch.zeros(3)})
        for d in (sd, short, bad, extra):
            assert tconvert.validate_hf_t5_state_dict(d, cfg) == \
                jconvert.validate_hf_t5_state_dict(d, jcfg)
        assert tconvert.validate_hf_t5_state_dict(short, cfg)[0] == \
            ["encoder.final_layer_norm.weight"]
        assert tconvert.validate_hf_t5_state_dict(bad, cfg)[1][0][0] == \
            "shared.weight"
        assert tconvert.detect_kind(sd) == jconvert.detect_kind(sd) == \
            "prot_t5"
    assert tconvert.detect_kind(_bilm_sd()) == "bilstm"
    for damaged in ({"some.other.key": np.zeros(3)}, {}):
        for mod in (tconvert, jconvert):
            with pytest.raises(ValueError, match="unrecognised checkpoint"):
                mod.detect_kind(damaged)


def test_convert_checkpoint_refuses_a_damaged_t5(tmp_path):
    sd, _ = _t5_sd()
    sd["encoder.block.1.layer.0.SelfAttention.q.weight"] = torch.zeros(3, 3)
    f = tmp_path / "bad.bin"
    torch.save(sd, str(f))
    with pytest.raises(ValueError, match="does not match the expected HF"):
        tconvert.convert_checkpoint(str(f), str(tmp_path / "out"))
    with pytest.raises(FileNotFoundError, match="no pytorch_model.bin"):
        tconvert.convert_checkpoint(str(tmp_path), str(tmp_path / "out"))


def _bilm_artifact(tmp_path, capsys):
    f = tmp_path / "lstm2x.pt"
    torch.save(_bilm_sd(seed=5), str(f))
    out = str(tmp_path / "bilm")
    assert tconvert_cli.main([str(f), "--output", out, "--kind",
                              "bilstm"]) == 0
    assert json.loads(capsys.readouterr().out)["config"] == BILM
    return out


def test_build_model_with_a_bilm_artifact(tmp_path, capsys):
    """``cli.convert_lm`` writes the artifact; ``build_model`` sizes the
    heads from it (``embedding_dim`` = its 32 features, ``vocab_size`` =
    its 22 ids, +22 for the one-hot channel) and switches to the
    Uniprot21 tokenizer, as the JAX ``build_model`` does; the LM carries
    the artifact's weights."""
    out = _bilm_artifact(tmp_path, capsys)
    fields = dict(lm_type="bilstm", embedding_dim=999, vocab_size=32)
    model = tcommon.build_model(ttrainer.DeepBLASTConfig(**fields), out,
                                device="cpu")
    jmodel = jcommon.build_model(jtrainer.DeepBLASTConfig(**fields), out)
    for k in ("embedding_dim", "vocab_size", "lm_type"):
        assert getattr(model.config, k) == getattr(jmodel.config, k)
    assert model.config.embedding_dim == 32 and model.config.vocab_size == 22
    assert isinstance(model.tokenizer, UniprotPairTokenizer)
    assert type(jmodel.tokenizer).__name__ == "UniprotPairTokenizer"
    assert model.aligner.match_embedding.embed.in_features == 32 + 22
    _same_sd({k: v for k, v in model.lm.state_dict().items()},
             tconvert.load_converted_lm(out)[1])


def test_cli_train_pretrain_path_then_load_model(tmp_path, capsys):
    """``cli.train --pretrain-path <BiLM artifact>``: config.json says
    bilstm with the artifact's widths and records its geometry and
    tokenizer; ``load_model`` rebuilds that BiLM (the artifact's weights)
    with ``UniprotPairTokenizer`` and aligns with the in-memory model's
    states."""
    out = _bilm_artifact(tmp_path, capsys)
    train, valid = tmp_path / "train.tsv", tmp_path / "valid.tsv"
    _write_tsv(train, fixture_frame(n_rows=8, seed=1))
    _write_tsv(valid, fixture_frame(n_rows=4, seed=2))
    run = tmp_path / "run"
    assert ttrain.main([
        "--train-pairs", str(train), "--valid-pairs", str(valid),
        "-o", str(run), "--hidden-dim", "8", "--batch-size", "4",
        "--epochs", "1", "--max-len", "64", "--pretrain-path", out,
        "--device", "cpu"]) == 0
    with open(run / "config.json") as f:
        cfg = json.load(f)
    assert (cfg["lm_type"], cfg["embedding_dim"], cfg["vocab_size"]) == \
        ("bilstm", 32, 22)
    assert cfg["bilm"] == dict(BILM, tokenizer="uniprot")
    model = load_model(str(run), device="cpu")
    assert isinstance(model.tokenizer, UniprotPairTokenizer)
    _same_sd(model.lm.state_dict(), tconvert.load_converted_lm(out)[1])
    mem = tcommon.build_model(model.config, out, device="cpu")
    mem.aligner.load_state_dict(model.aligner.state_dict())
    for x, y in (("ACDEFGHIKL", "ACDFGHIKLM"), ("MKTAYIAKOU", "MKTAYK")):
        s = model.align(x, y)
        assert s == mem.align(x, y)
        assert s.count(":") + s.count("1") == len(x)


def test_build_model_and_cli_train_with_a_raw_hf_directory(tmp_path):
    """A raw HF directory means ProtT5 (``_pretrained_lm_type``): the
    encoder of ``load_prot_t5`` with the ProtT5 tokenizer, the heads
    sized from its ``d_model``; ``cli.train`` keeps its geometry in
    config.json's ``"t5"`` block, and ``load_model`` serves the LM."""
    _, d = _hf_dir(tmp_path, "relu")
    args = tcommon.add_infra_args(tcommon.add_model_args(
        __import__("argparse").ArgumentParser())).parse_args(
        ["--train-pairs", "t", "--valid-pairs", "v", "-o", "o",
         "--pretrain-path", d])
    config = tcommon.config_from_args(args)
    assert config.lm_type == "prot_t5"
    model = tcommon.build_model(config, d, device="cpu")
    assert isinstance(model.tokenizer, ProtT5Tokenizer)
    assert model.lm.cfg.d_model == 32 and model.lm.cfg.num_layers == 2
    assert model.aligner.match_embedding.embed.in_features == 32
    _same_sd(model.lm.state_dict(), tlm.load_prot_t5(d)[1])
    train, valid = tmp_path / "train.tsv", tmp_path / "valid.tsv"
    _write_tsv(train, fixture_frame(n_rows=4, seed=1))
    _write_tsv(valid, fixture_frame(n_rows=2, seed=2))
    run = tmp_path / "run"
    assert ttrain.main([
        "--train-pairs", str(train), "--valid-pairs", str(valid),
        "-o", str(run), "--hidden-dim", "8", "--batch-size", "4",
        "--epochs", "1", "--max-len", "64", "--pretrain-path", d,
        "--device", "cpu"]) == 0
    served = load_model(str(run), device="cpu")
    assert served.lm.cfg == model.lm.cfg
    _same_sd(served.lm.state_dict(), model.lm.state_dict())
    assert len(served.align("ACDEFG", "ACDFG")) >= 6


def test_load_model_refuses_a_jax_bilm_artifact_config(tmp_path):
    """The JAX config.json of a model trained from a Bepler artifact
    (lm_type bilstm, vocab_size 22, no geometry): the JAX package rebuilds
    another BiLM (embedding width 8, not the artifact's 21) and the ProtT5
    tokenizer, whose ids reach 23; the port refuses it."""
    fields = dict(lm_type="bilstm", embedding_dim=32, vocab_size=22)
    with open(tmp_path / "config.json", "w") as f:
        f.write(jtrainer.DeepBLASTConfig(**fields).to_json())
    jmodel = jtrainer.DeepBLAST(jtrainer.DeepBLASTConfig(**fields))
    assert jmodel.lm.embedding_dim == 8 != BILM["embedding_dim"]
    assert type(jmodel.tokenizer).__name__ == "ProtT5Tokenizer"
    with pytest.raises(ValueError, match="without the port.s .bilm. block"):
        load_model(str(tmp_path), device="cpu")
