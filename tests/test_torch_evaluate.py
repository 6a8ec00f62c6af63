"""The evaluation entry points of the port against the JAX package on the
CPU: ``cli.evaluate`` (``DeepBLAST.test``), ``cli.mali_align``,
``cli.tensorboard2csv`` and ``TMAlignDataset``'s options.

The model is a tiny JAX ``deepblast-train`` directory (the config of
``tests/test_torch_jax_model.py``, seed 3, an orbax checkpoint at step 5
of another init, float32 DP storage) converted by
``scripts/torch_import_jax_model.py``, so both packages serve the same
weights.  ``evaluate``'s traceback statistics are discrete, so the two
CSVs must be equal, byte for byte and read back; ``mali_align``'s CSV must
be byte for byte the file that the JAX package's pieces give (``readPDB``,
``align(s1.seq, s0.seq)``, pandas' ``to_csv`` after the rename): the JAX
CLI itself reads the pairs with ``res.iloc[i][0]``, which pandas 3 reads
by label and fails on (ROADMAP.md C).
"""

import json
import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from deepblast_torch.cli import evaluate as tevaluate
from deepblast_torch.cli import mali_align as tmali
from deepblast_torch.cli import tensorboard2csv as ttb2csv
from deepblast_torch.data import dataset as tdataset
from deepblast_torch.train.checkpoint import load_model
from deepblast_torch.utils import logging as tlogging
from deepblast_tpu.cli import evaluate as jevaluate
from deepblast_tpu.cli import mali_align as jmali
from deepblast_tpu.data import dataset as jdataset
from deepblast_tpu.data.parse_pdb import readPDB
from deepblast_tpu.train import checkpoint as jcheckpoint
from deepblast_tpu.utils import logging as jlogging
from synthetic_pairs import RESIDUES, homolog_row, write_structure_pair
from test_torch_eval import same
from test_torch_jax_model import _jax_dir, _script
from tests.test_train import fixture_frame
import torch_threads  # noqa: F401  (PyTorch threads a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TM_TAB = os.path.join(REPO, "tests", "data", "test_tm_align.tab")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """``(JAX model directory, the port's conversion of it)``."""
    root = tmp_path_factory.mktemp("model")
    jax_dir = _jax_dir(root / "jax", {})
    port_dir = str(root / "port")
    assert _script().main([jax_dir, port_dir]) == 0
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def jmodel(dirs):
    model = jcheckpoint.load_model(dirs[0])
    model._embeddings = jax.jit(model._embeddings, static_argnames="frozen")
    return model


def test_evaluate_matches_jax(tmp_path, dirs, capsys):
    """7 rows, one of them 70 residues long (past ``max_len`` 64, dropped):
    two batches of 4 and 2.  Then ``test()`` on the config's
    ``test_pairs`` gives the CSV's rows."""
    df = fixture_frame(7, seed=5)
    long = "".join(np.random.default_rng(0).choice(list(RESIDUES), 70))
    df.iloc[3, 5], df.iloc[3, 6], df.iloc[3, 7] = long, long, ":" * 70
    tsv = tmp_path / "test.tab"
    df.to_csv(tsv, sep="\t", header=False, index=False)
    argv = ["--load-from-checkpoint", None, "--test-pairs", str(tsv), "-o"]
    argv[1] = dirs[0]
    assert jevaluate.main(argv + [str(tmp_path / "jax")]) == 0
    argv[1] = dirs[1]
    assert tevaluate.main(argv + [str(tmp_path / "port"), "--device",
                                  "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == (f"wrote {tmp_path / 'port' / 'test.tab-results.csv'} "
                       f"(6 rows)")
    got = tmp_path / "port" / "test.tab-results.csv"
    want = tmp_path / "jax" / "test.tab-results.csv"
    assert got.read_bytes() == want.read_bytes()
    gdf, wdf = (pd.read_csv(f, float_precision="round_trip")
                for f in (got, want))
    pd.testing.assert_frame_equal(gdf, wdf)
    assert list(gdf.columns) == ["Unnamed: 0"] + [
        f"test_{c}" for c in ("tp", "fp", "fn", "perc_id", "ppv", "fnr",
                              "fdr")] + ["query_name", "key_name"]
    assert sorted(gdf["query_name"]) == [f"q{i}" for i in (0, 1, 2, 4, 5, 6)]

    model = load_model(dirs[1], device="cpu")
    model.config.test_pairs = str(tsv)
    rows = model.test()
    assert [list(r.values()) for r in rows] == \
        gdf.drop(columns="Unnamed: 0").values.tolist()


def _structures(tmp_path, n=3):
    """Malidup-like inputs: ``n`` homolog pairs of 20-30 residues
    (``synthetic_pairs.homolog_row``) as chains carved out of one fold
    (``synthetic_pairs.write_structure_pair``), and the pairs CSV (pandas'
    ``to_csv``; column 0 the y chain's file, 1 the x chain's, 2 the true
    states)."""
    rng = np.random.default_rng(8)
    rows = []
    for t in range(n):
        row = homolog_row(rng, f"p{t}", 20, 30)
        write_structure_pair(rng, row, str(tmp_path / f"p{t}_x.pdb"),
                             str(tmp_path / f"p{t}_y.pdb"))
        rows.append((f"p{t}_y.pdb", f"p{t}_x.pdb", row[7]))
    pairs = tmp_path / "pairs.csv"
    pd.DataFrame(rows, columns=["0", "1", "2"],
                 index=[3, 5, 9][:n]).to_csv(pairs)
    return str(pairs)


def test_mali_align_matches_jax_pieces(tmp_path, dirs, jmodel):
    pairs = _structures(tmp_path)
    out = tmp_path / "port.csv"
    assert tmali.main(["--mali-pairs", pairs, "--input-mali-dir",
                       str(tmp_path), "--load-from-checkpoint", dirs[1],
                       "--output-alignments", str(out), "--device",
                       "cpu"]) == 0

    res = pd.read_csv(pairs, index_col=0)
    aligned = []
    for i in range(len(res)):
        pdb0, pdb1 = res.iloc[i].iloc[0], res.iloc[i].iloc[1]
        _, s0 = readPDB(f"{tmp_path}/{pdb0}")
        _, s1 = readPDB(f"{tmp_path}/{pdb1}")
        aligned.append(jmodel.align(s1.seq, s0.seq))
    res["deepblast"] = aligned
    res = res.rename(columns={"0": "query_seq", "1": "hit_seq",
                              "2": "manual"})
    res.to_csv(tmp_path / "jax.csv")
    assert out.read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert out.read_text().splitlines()[0] == \
        ",query_seq,hit_seq,manual,deepblast"


def test_jax_mali_align_cli_under_this_pandas(tmp_path, dirs):
    """The JAX CLI's ``res.iloc[i][0]``: pandas 3 reads the label ``0``,
    which the pairs CSV does not have (its labels are "0", "1", "2"), and
    raises; an older pandas fell back to the position and wrote the
    port's file."""
    pairs = _structures(tmp_path, n=1)
    argv = ["--mali-pairs", pairs, "--input-mali-dir", str(tmp_path),
            "--output-alignments"]
    if int(pd.__version__.split(".")[0]) >= 3:
        with pytest.raises(KeyError):
            jmali.main(argv + [str(tmp_path / "jax.csv"),
                               "--load-from-checkpoint", dirs[0]])
        return
    assert jmali.main(argv + [str(tmp_path / "jax.csv"),
                              "--load-from-checkpoint", dirs[0]]) == 0
    assert tmali.main(argv + [str(tmp_path / "port.csv"),
                              "--load-from-checkpoint", dirs[1],
                              "--device", "cpu"]) == 0
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()


def _jax_log(root):
    log = jlogging.MetricsLogger(str(root), "jax", tensorboard=False)
    for step in range(3):
        log.log_scalar("train_loss", 1.0 / (step + 1), step)
        log.log_text("alignment/0", "text", step)
    log.log_scalar("val_tp", 17, 3)
    log.log_scalar("validation_loss", 0.125, 3)
    log.close()
    return log.path


def _port_log(root):
    log = tlogging.MetricsLogger(str(root), "port")
    for step in range(3):
        log.log_scalar("train_loss", 2.0 ** -step, step)
    log.log_scalar("val_perc_id", 0.3333333333333333, 3)
    log.close()
    return log.path


@pytest.mark.parametrize("pattern", [None, "loss", "absent"])
def test_tensorboard2csv_matches_jax(tmp_path, pattern):
    """Both loggers' ``metrics.jsonl`` (the port's with ``wall_time``)
    through both packages' ``tensorboard_to_csv``: the same bytes."""
    for logdir in (_jax_log(tmp_path), _port_log(tmp_path)):
        name = os.path.basename(logdir)
        got, want = tmp_path / f"{name}_t.csv", tmp_path / f"{name}_j.csv"
        rows = tlogging.tensorboard_to_csv(logdir, str(got), pattern)
        df = jlogging.tensorboard_to_csv(logdir, str(want), pattern)
        assert got.read_bytes() == want.read_bytes()
        assert len(rows) == len(df)
        if pattern is None and name == "port":
            assert got.read_text().splitlines()[0] == \
                "tag,value,step,wall_time"
        argv = ["--logdir", logdir, "--output-csv", str(got)]
        assert ttb2csv.main(argv + (["--pattern", pattern] if pattern
                                    else [])) == 0
        assert got.read_bytes() == want.read_bytes()


def test_tensorboard2csv_refuses_a_logdir_without_jsonl(tmp_path):
    with pytest.raises(FileNotFoundError, match="queue A item 7"):
        ttb2csv.main(["--logdir", str(tmp_path), "--output-csv",
                      str(tmp_path / "m.csv")])
    assert not (tmp_path / "m.csv").exists()


OPTIONS = [dict(), dict(return_names=True), dict(construct_paths=True),
           dict(return_names=True, construct_paths=True),
           dict(max_len=300, return_names=True)]


@pytest.mark.parametrize("kw", OPTIONS, ids=lambda kw: ",".join(kw) or "-")
def test_tmalign_dataset_options_match_jax(kw):
    """Every item of the TM-align fixture (its pairs under ``max_len``)
    under the options that the port takes."""
    ds_t = tdataset.TMAlignDataset(TM_TAB, tm_threshold=0.0, **kw)
    ds_j = jdataset.TMAlignDataset(TM_TAB, tm_threshold=0.0, **kw)
    assert len(ds_t) == len(ds_j) > 0
    assert same(ds_t.lengths(), ds_j.lengths())
    for i in range(len(ds_t)):
        assert same(ds_t[i], ds_j[i]), i


def test_evaluate_and_mali_align_raise_without_cuda(monkeypatch, tmp_path):
    """No CUDA device and no ``--device cpu``: both raise instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with open(tmp_path / "config.json", "w") as f:
        json.dump({}, f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tevaluate.main(["--load-from-checkpoint", str(tmp_path),
                        "--test-pairs", "t", "-o", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmali.main(["--mali-pairs", "p", "--input-mali-dir", "d",
                    "--load-from-checkpoint", str(tmp_path),
                    "--output-alignments", "o"])
