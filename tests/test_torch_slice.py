"""The serving slice as a whole: the JAX package's ``DeepBLAST`` (tiny T5
encoder + CNN heads, scan backend) against the port's ``DeepBLAST`` on
the CPU with the same weights carried across by ``params_from_jax``;
the port's checkpoint and search CLI; and the guards that keep the port
free of JAX and off a silent CPU path.

Tolerances: ``align`` state strings identical; ``score_pairs`` rtol 1e-5
(fp32 model, the same operations in two libraries; sparsemax 2e-5, read
1.2e-5: its threshold ``tau`` sums and divides the sorted arguments); the
search CLI's 4-decimal output against ``score_pairs`` to its rounding.
The model is nw and softmax; every mode and operator is held to JAX at
the model level too, on pairs that include 1 x 8 and 8 x 1.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepblast_torch.cli import common as tcommon
from deepblast_torch.cli import search as tsearch
from deepblast_torch.data.state_utils import pad_sequences
from deepblast_torch.models import lm as tlm
from deepblast_torch.models.convert import params_from_jax
from deepblast_torch.train import trainer as ttrainer
from deepblast_torch.train.checkpoint import load_model, save_model
from deepblast_tpu.models import lm as jlm
from deepblast_tpu.train import trainer as jtrainer
import torch_threads  # noqa: F401  (PyTorch threads a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "deepblast_tpu",
             "transformers"}
# real protein pairs of the JAX package's golden fixtures
PAIRS = [
    ("HECDRKTCDESFSTKGNLRVHKLGH", "LKCSGCGKNFKSQYAYKRHEQTH"),
    ("YRCHKVCPYTFVGKSDLDLHQFITAH", "HECDDCSKQFSRNNHLAKHLRAH"),
    ("YACSGGCGQNFRTMSEFNEHMIRLVH", "LICPKHTRDCGKVFKRNSSLRVHEH"),
    ("LNCKEIKKYCEMSFRNPDDIRKHRGAIH", "YTCSSCNESLRTAWCLNKHLR"),
]
# the pairs of the mode x operator matrix: one residue against eight, both
# ways, beside PAIRS (two scored, one aligned: each JAX align traces anew)
EDGE_PAIRS = [("W", "HECDRKTC"), ("HECDRKTC", "W")]
MODEL = dict(lm_type="prot_t5", embedding_dim=32, hidden_dim=16, layers=2,
             k_size=5, layer_type="cnn", alignment_mode="needleman-wunsch",
             operator="softmax")


@pytest.fixture(scope="module")
def models():
    jmodel = jtrainer.DeepBLAST(
        jtrainer.DeepBLASTConfig(backend="scan", **MODEL),
        lm=jlm.T5Encoder(jlm.T5Config.tiny()))
    jmodel.state = jmodel.init(jax.random.key(0))
    tmodel = ttrainer.DeepBLAST(
        ttrainer.DeepBLASTConfig(**MODEL),
        lm=tlm.T5Encoder(tlm.T5Config.tiny()),
        lm_params=params_from_jax(jmodel.state.lm_params), device="cpu")
    tmodel.aligner.load_state_dict(
        params_from_jax(jmodel.state.params["aligner"]))
    return jmodel, tmodel


def _batch(pairs, tok, pad_to=None):
    xt, xl = pad_sequences([tok(x)[0] for x, _ in pairs])
    yt, yl = pad_sequences([tok(y)[0] for _, y in pairs])
    if pad_to:
        xt = np.pad(xt, ((0, 0), (0, pad_to - xt.shape[1])))
        yt = np.pad(yt, ((0, 0), (0, pad_to - yt.shape[1])))
    return dict(x=xt, y=yt, x_len=xl, y_len=yl)


def test_align_matches_jax(models):
    jmodel, tmodel = models
    for x, y in PAIRS:
        want = jmodel.align(x, y)
        got = tmodel.align(x, y)
        assert got == want
        assert got.count("1") + got.count(":") == len(x)
        assert got.count("2") + got.count(":") == len(y)


def test_score_pairs_matches_jax(models):
    jmodel, tmodel = models
    batch = _batch(PAIRS, tmodel.tokenizer, pad_to=32)
    want = np.asarray(jmodel.score_pairs(
        jmodel.state, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = tmodel.score_pairs(batch)
    assert got.dtype == torch.float32 and got.shape == (len(PAIRS),)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("mode", ["needleman-wunsch", "smith-waterman"])
@pytest.mark.parametrize("operator", ["softmax", "sparsemax", "hardmax"])
def test_modes_and_operators_match_jax(models, mode, operator):
    """``align`` and ``score_pairs`` of the fixture's weights under every
    alignment mode and operator."""
    jbase, tbase = models
    cfg = dict(MODEL, alignment_mode=mode, operator=operator)
    jmodel = jtrainer.DeepBLAST(
        jtrainer.DeepBLASTConfig(backend="scan", **cfg), lm=jbase.lm)
    jmodel.state = jbase.state
    tmodel = ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig(**cfg),
                                lm=tbase.lm, device="cpu")
    tmodel.aligner.load_state_dict(tbase.aligner.state_dict())
    for x, y in PAIRS[:1] + EDGE_PAIRS:
        assert tmodel.align(x, y) == jmodel.align(x, y), (x, y)
    batch = _batch(PAIRS[:2] + EDGE_PAIRS, tmodel.tokenizer, pad_to=32)
    want = np.asarray(jmodel.score_pairs(
        jmodel.state, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = tmodel.score_pairs(batch).numpy()
    np.testing.assert_allclose(
        got, want, rtol=2e-5 if operator == "sparsemax" else 1e-5)


def test_checkpoint_and_search_cli(models, tmp_path):
    _, tmodel = models
    ckpt = str(tmp_path / "model")
    save_model(tmodel, ckpt)
    loaded = load_model(ckpt, device="cpu")
    batch = _batch(PAIRS, tmodel.tokenizer)
    np.testing.assert_array_equal(loaded.score_pairs(batch).numpy(),
                                  tmodel.score_pairs(batch).numpy())

    queries = [x for x, _ in PAIRS[:3]]
    db = [y for _, y in PAIRS[:2]]
    for name, seqs, pre in (("q.fa", queries, "q"), ("db.fa", db, "d")):
        with open(tmp_path / name, "w") as f:
            for i, s in enumerate(seqs):
                f.write(f">{pre}{i} protein\n{s[:10]}\n{s[10:]}\n")
    out = tmp_path / "hits.tsv"
    assert tsearch.main([
        "--query-fasta", str(tmp_path / "q.fa"),
        "--db-fasta", str(tmp_path / "db.fa"),
        "--load-from-checkpoint", ckpt, "--output-file", str(out),
        "--batch-size", "4", "--pad-multiple", "16",
        "--device", "cpu"]) == 0
    rows = [line.split("\t") for line in out.read_text().splitlines()]
    # database-major order, as the JAX search writes it
    assert [(r[0], r[1]) for r in rows] == [
        (f"q{i}", f"d{j}") for j in range(2) for i in range(3)]
    pairs = [(queries[int(r[0][1:])], db[int(r[1][1:])]) for r in rows]
    want = tmodel.score_pairs(_batch(pairs, tmodel.tokenizer)).numpy()
    for r, s, (x, y) in zip(rows, want, pairs):
        assert float(r[2]) == pytest.approx(float(s), abs=2e-4)
        assert float(r[3]) == pytest.approx(float(s) / (len(x) * len(y)),
                                            abs=2e-4)


def _port_files():
    root = os.path.join(REPO, "deepblast_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax_ast():
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_port_imports_no_jax_at_runtime():
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepblast_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(deepblast_torch.__path__,\n"
        "                               'deepblast_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules\n"
        "           if k.startswith('deepblast_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """No CUDA device and no explicit device="cpu": the entry points
    raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.DeepBLAST(ttrainer.DeepBLASTConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcommon.build_model(ttrainer.DeepBLASTConfig(lm_type="bilstm"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsearch.main(["--query-fasta", "q", "--db-fasta", "d",
                      "--load-from-checkpoint", str(tmp_path),
                      "--output-file", str(tmp_path / "out")])
