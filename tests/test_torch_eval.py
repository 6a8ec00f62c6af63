"""The evaluation library of the port against the JAX package on the CPU:
``data/state_utils.py``'s gap trimming, orphan removal and token
decoding, ``eval/score.py``, ``eval/metrics.py``, ``data/parse_pdb.py``,
``data/dssp.py``, ``data/parsers.py``, ``data/substitution.py``, ``sim.py``
and ``data/dataset.py``'s ``MaliAlignmentDataset`` and batching, each on
the same inputs as the JAX function (the JAX package's test cases and the
fixtures under ``tests/data/``).

Where the JAX function returns a ``pandas.DataFrame`` the port returns
dict rows: ``df.to_dict("records")`` must equal them (a missing value of a
ragged frame, NaN there, is None in the port's row).  The port runs
the JAX package's numpy code in the same order, so every result is held
exactly (floats bit for bit, NaN where JAX has NaN); files are compared
byte for byte.
"""

import ast
import io
import math
import os
import random
import shutil
import subprocess

import numpy as np
import pandas as pd
import pytest

from deepblast_torch import sim as tsim
from deepblast_torch.cli import hmm_simulate as thmm_cli
from deepblast_torch.data import dataset as tdataset
from deepblast_torch.data import dssp as tdssp
from deepblast_torch.data import parse_pdb as tpdb
from deepblast_torch.data import parsers as tparsers
from deepblast_torch.data import state_utils as tsu
from deepblast_torch.data import substitution as tsub
from deepblast_torch.eval import metrics as tmetrics
from deepblast_torch.eval import score as tscore
from deepblast_tpu import sim as jsim
from deepblast_tpu.cli import hmm_simulate as jhmm_cli
from deepblast_tpu.data import dataset as jdataset
from deepblast_tpu.data import dssp as jdssp
from deepblast_tpu.data import parse_pdb as jpdb
from deepblast_tpu.data import parsers as jparsers
from deepblast_tpu.data import state_utils as jsu
from deepblast_tpu.data import substitution as jsub
from deepblast_tpu.eval import metrics as jmetrics
from deepblast_tpu.eval import score as jscore
from synthetic_pairs import segmented_fold
import torch_threads  # noqa: F401  (PyTorch threads a worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
HMM = os.path.join(DATA, "zf-C2H2.hmm")
STO = os.path.join(DATA, "zf-C2H2-hmmemit.sto")
TM_TAB = os.path.join(DATA, "test_tm_align.tab")
AA_123 = {v: k for k, v in jpdb.AA_321.items()}


def same(a, b):
    """Equal values, recursively through tuples, lists, dicts and arrays;
    NaN equals NaN."""
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) and all(
            same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and \
            np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def records(df):
    """``df.to_dict("records")`` with None for the NaN of a ragged frame's
    missing cells."""
    return [{k: None if isinstance(v, float) and math.isnan(v) else v
             for k, v in r.items()} for r in df.to_dict("records")]


# ---------------------------------------------------------------------------
# state_utils
# ---------------------------------------------------------------------------

def _random_states(rng, n, p_gap):
    return "".join(rng.choice([":", "1", "2"], n,
                              p=[1 - p_gap, p_gap / 2, p_gap / 2]))


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("seed", range(3))
def test_trim_gap_span_matches_jax(k, seed):
    rng = np.random.default_rng(seed)
    v = rng.random(60) < [0.9, 0.3, 0.6][seed]
    assert tsu.trim_gap_span(v, k) == jsu.trim_gap_span(v, k)


def test_trim_gap_matches_jax():
    rows = [dict(chain1="AAA", chain2="BBBBBBB", alignment=":2222::"),
            dict(chain1="ACDE", chain2="ACDE", alignment="::::")]
    rng = np.random.default_rng(1)
    for i in range(6):
        st = _random_states(rng, 50, 0.5)
        x = "".join(rng.choice(list("ACDEFGHIK"), st.count(":")
                               + st.count("1")))
        y = "".join(rng.choice(list("ACDEFGHIK"), st.count(":")
                               + st.count("2")))
        rows.append(dict(chain1_name=f"q{i}", chain1=x, chain2=y,
                         alignment=st))
    for r in rows:
        for k in (3, 5, 10):
            assert tsu.trim_gap(r, k) == jsu.trim_gap(r, k), (r, k)


@pytest.mark.parametrize("threshold", [5, 11])
def test_remove_orphans_matches_jax(threshold):
    cases = ["1" * 6 + ":" + "1" * 6, ":::" + "1" * 3 + ":::",
             "2" * 7 + "::" + "2" * 7 + ":::::"]
    rng = np.random.default_rng(threshold)
    cases += [_random_states(rng, 40, 0.8) for _ in range(5)]
    for s in cases:
        assert tsu.remove_orphans(s, threshold) == \
            jsu.remove_orphans(s, threshold), s


def test_decode_tokens_matches_jax():
    vocab = {"▁A": 3, "C": 4, "▁D": 5, "E": 6}
    codes = np.array([3, 4, 5, 6, 3], np.int32)
    assert tsu.decode_tokens(codes, vocab) == \
        jsu.decode_tokens(codes, vocab) == "ACDEA"


# ---------------------------------------------------------------------------
# eval/score.py
# ---------------------------------------------------------------------------

STATE_PAIRS = [(":::", ":::"), (":1:2:", "::12:"), ("::11::22::", ":::::1:2:2"),
               ("1:::2", ":2::1")]


@pytest.mark.parametrize("width", [1, 2, 3])
def test_roc_edges_kernel_identity_matches_jax(width):
    true = [(0, 0), (1, 1), (2, 3), (4, 4)]
    pred = [(1, 1), (2, 2), (3, 3), (5, 6)]
    assert tscore.roc_edges_kernel_identity(true, pred, width) == \
        jscore.roc_edges_kernel_identity(true, pred, width)


@pytest.mark.parametrize("no_gaps", [True, False])
def test_alignment_score_matches_jax(no_gaps):
    for true, pred in STATE_PAIRS:
        assert tscore.alignment_score(true, pred, no_gaps) == \
            jscore.alignment_score(true, pred, no_gaps)
        ts = [tsu.tmstate_f(c) for c in true]
        ps = np.array([tsu.tmstate_f(c) for c in pred])
        assert tscore.alignment_score(ts, ps, no_gaps) == \
            jscore.alignment_score(ts, ps, no_gaps)


def test_alignment_score_kernel_matches_jax():
    for true, pred in STATE_PAIRS:
        for qo, ho in ((0, 0), (1, 0), (0, 2)):
            assert tscore.alignment_score_kernel(
                true, pred, [1, 2, 4], qo, ho) == \
                jscore.alignment_score_kernel(true, pred, [1, 2, 4], qo, ho)


def test_alignment_text_matches_jax():
    pred = np.array([1, 0, 1, 2, 1])
    truth = np.array([1, 1, 0, 2, 1])
    stats = [3, 1, 1, 0.6666667, 0.75, 0.25, 0.25]
    assert tscore.alignment_text("ACDE", "FGHI", pred, truth, stats) == \
        jscore.alignment_text("ACDE", "FGHI", pred, truth, stats)


@pytest.mark.parametrize("n_cores", [1, 2])
def test_score_alignments_matches_jax(n_cores):
    """The port's pool (``spawn``) gives the rows JAX's serial map gives
    (JAX is run in this process: a fork of it would copy its threads)."""
    rows = [(t, p) for t, p in STATE_PAIRS] + [(":::", ":::", 1, 0),
                                               ("::1:", "::2:", 0, 1)]
    assert tscore.score_alignments(rows, (1, 2), n_cores) == \
        jscore.score_alignments(rows, (1, 2), 1)


# ---------------------------------------------------------------------------
# structures: parse_pdb, dssp, metrics
# ---------------------------------------------------------------------------

def write_pdb(path, coords, seq=None, idx=None, altloc_every=0):
    """Backbone atoms of residues ``idx`` (default all) of ``coords``, the
    residue names from ``seq`` (ALA without one)."""
    idx = range(coords["CA"].shape[0]) if idx is None else idx
    serial = 1
    with open(path, "w") as f:
        f.write("HEADER    SYNTHETIC\n")
        for r, i in enumerate(idx):
            name = AA_123.get(seq[r], "ALA") if seq else "ALA"
            for key, lab in (("N", " N  "), ("CA", " CA "), ("C", " C  "),
                             ("O", " O  ")):
                x, y, z = coords[key][i]
                for alt in (" ", "B") if altloc_every and \
                        r % altloc_every == 0 else (" ",):
                    f.write(f"ATOM  {serial:5d} {lab}{alt}{name} A"
                            f"{r + 1:4d}    {x:8.3f}{y:8.3f}{z:8.3f}"
                            f"  1.00  0.00           {lab.strip()[0]}\n")
                    serial += 1
        f.write("TER\nEND\n")


def structure_pair(tmp_path, seed, ncols=40):
    """Two chains carved out of one fold over an alignment's columns:
    ``(x, y, states, pdb of x, pdb of y)``."""
    rng = np.random.default_rng(seed)
    states = _random_states(rng, ncols, 0.3)
    co = jdssp.build_backbone(segmented_fold(rng, ncols))
    xi = [i for i, s in enumerate(states) if s in ":1"]
    yi = [i for i, s in enumerate(states) if s in ":2"]
    x = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), len(xi)))
    y = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), len(yi)))
    p0, p1 = str(tmp_path / f"s{seed}_x.pdb"), str(tmp_path / f"s{seed}_y.pdb")
    write_pdb(p0, co, x, xi)
    write_pdb(p1, co, y, yi)
    return x, y, states, p0, p1


def test_read_pdb_matches_jax(tmp_path):
    co = jdssp.build_backbone([(-57.0, -47.0)] * 8)
    good = tmp_path / "good.pdb"
    write_pdb(str(good), co, "ACDEFGHW")
    bad = tmp_path / "bad.pdb"
    bad.write_text(
        "ATOM      1  CA  ALA A   1      11.639   6.071  -5.147  1.00\n"
        "HETATM    2  CA  MSE A   3       8.304   5.024  -4.020  1.00\n"
        "ATOM      3  CA  GLY A   3       8.304   5.024  -4.020  1.00\n"
        "ENDMDL\n"
        "ATOM      4  CA  GLY A   4       1.000   2.000   3.000  1.00\n")
    for f in (good, bad):
        t_ok, t = tpdb.readPDB(str(f))
        j_ok, j = jpdb.readPDB(str(f))
        assert t_ok == j_ok and same(tuple(t), tuple(j))
    assert tpdb.AA_321 == jpdb.AA_321


PHI_PSI = {"alpha": [(-57.0, -47.0)] * 16, "310": [(-49.0, -26.0)] * 14,
           "pi": [(-55.0, -70.0)] * 14, "strand": [(-139.0, 135.0)] * 10}


@pytest.mark.parametrize("fold", sorted(PHI_PSI))
def test_dssp_matches_jax(fold):
    co_t = tdssp.build_backbone(PHI_PSI[fold])
    co_j = jdssp.build_backbone(PHI_PSI[fold])
    assert same(co_t, co_j)
    L = len(PHI_PSI[fold])
    names = ["ALA"] * L
    names[L // 2] = "PRO"
    nums = np.concatenate([np.arange(L // 2), np.arange(50, 50 + L - L // 2)])
    breaks = np.zeros(L - 1, bool)
    for args in ((breaks,), (breaks, names)):
        H = tdssp.place_amide_hydrogens(co_t, *args)
        assert same(H, jdssp.place_amide_hydrogens(co_j, *args))
        assert same(tdssp.hbond_matrix(co_t, H), jdssp.hbond_matrix(co_j, H))
    for kw in ({}, dict(resnames=names), dict(resnums=nums)):
        assert tdssp.assign_secondary_structure(co_t, **kw) == \
            jdssp.assign_secondary_structure(co_j, **kw)


def _two_strands(dx, dy, dz, L=8):
    s1 = jdssp.build_backbone([(-139.0, 135.0)] * L)
    R = np.diag([-1.0, 1.0, -1.0])
    x0 = s1["CA"][-1][0] + s1["CA"][0][0]
    s2 = {k: (v @ R.T) + np.array([x0 + dx, dy, dz]) for k, v in s1.items()}
    co = {k: np.concatenate([s1[k], s2[k]]) for k in s1}
    return co, np.concatenate([np.arange(L), np.arange(100, 100 + L)])


@pytest.mark.parametrize("shift", [(1.0, 3.0, 0.9), (1.2, 3.0, 0.2)])
def test_dssp_bridges_match_jax(shift):
    """The E ladder and the isolated B bridge of ``tests/test_dssp.py``."""
    co, nums = _two_strands(*shift)
    got = tdssp.assign_secondary_structure(co, resnums=nums)
    assert got == jdssp.assign_secondary_structure(co, resnums=nums)
    assert ("E" in got) != ("B" in got)


def test_read_backbone_and_counts_match_jax(tmp_path):
    co = jdssp.build_backbone(segmented_fold(np.random.default_rng(3), 30))
    p = str(tmp_path / "fold.manual.pdb")
    write_pdb(p, co, "ACDEFGHIKLMNPQRSTVWY" * 2, altloc_every=3)
    assert same(tdssp.read_backbone(p), jdssp.read_backbone(p))
    assert tdssp.secondary_structure_counts(p) == \
        jdssp.secondary_structure_counts(p)


def test_kabsch_and_tm_match_jax():
    rng = np.random.default_rng(0)
    p1 = rng.standard_normal((30, 3)) * 5
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    p2 = p1 @ q.T + 1.5 + 0.1 * rng.standard_normal((30, 3))
    mirror = p1 * np.array([1.0, 1.0, -1.0])
    for a, b in ((p1, p2), (p1, mirror)):
        assert same(tmetrics.kabsch(a, b), jmetrics.kabsch(a, b))
        assert same(tmetrics.kabsch_template_alignment(a, b, a[:7], b[:7]),
                    jmetrics.kabsch_template_alignment(a, b, a[:7], b[:7]))
    assert tmetrics.tm_d0(40) == jmetrics.tm_d0(40)
    dev2 = rng.random(30)
    assert tmetrics.tm_score_from_dev2(dev2, 30) == \
        jmetrics.tm_score_from_dev2(dev2, 30)
    for s in (":1:2:", "::11::222:::", "1" * 3 + ":" * 5):
        assert same(tmetrics.parse_alignment_string(s),
                    jmetrics.parse_alignment_string(s))


@pytest.mark.parametrize("corrupt", [False, True])
def test_maxsub_and_standard_metrics_match_jax(corrupt):
    rng = np.random.default_rng(5)
    co = jdssp.build_backbone(segmented_fold(rng, 45))
    p = co["CA"]
    q = p + 0.3 * rng.standard_normal(p.shape)
    if corrupt:
        q[25:] += 4.0 * rng.standard_normal((20, 3))
    ai = np.stack([np.arange(45), np.arange(45)])
    got = tmetrics.FR_TM_maxsub_score(p, q, ai)
    want = jmetrics.FR_TM_maxsub_score(p, q, ai)
    assert same([tuple(t) for t in got], [tuple(t) for t in want])
    seq = "".join(rng.choice(list("ACDEFG"), 45))
    kw = dict(indicies=got[0].alignment, seq0=seq, seq1=seq[::-1])
    assert same(tuple(tmetrics.standard_metrics(p, q, ai, **kw)),
                tuple(jmetrics.standard_metrics(p, q, ai, **kw)))
    assert same(tuple(tmetrics.standard_metrics(p, q, ai)),
                tuple(jmetrics.standard_metrics(p, q, ai)))


@pytest.mark.parametrize("seed", range(3))
def test_process_alignment_matches_jax(tmp_path, seed):
    """``process_alignment`` on chains built by ``build_backbone``: the true
    and a shifted state string, both transposes."""
    x, y, states, p0, p1 = structure_pair(tmp_path, seed)
    shifted = states[1:] + states[:1]
    for aln in (states, shifted):
        for transpose in (True, False):
            kw = dict(pdb0=p0, pdb1=p1, transpose=transpose)
            if transpose:
                kw.update(pdb0=p1, pdb1=p0)
            try:
                want = tuple(jmetrics.process_alignment(aln, **kw))
            except (IndexError, AssertionError) as e:
                with pytest.raises(type(e)):
                    tmetrics.process_alignment(aln, **kw)
                continue
            assert same(tuple(tmetrics.process_alignment(aln, **kw)), want)


# ---------------------------------------------------------------------------
# parsers
# ---------------------------------------------------------------------------

TM2021_BLOCK = """
 *********************************************************************
 * TM-align (Version 20210224): protein structure alignment          *
 * References: Y Zhang, J Skolnick. Nucl Acids Res 33, 2302-9 (2005) *
 * Please email comments and suggestions to yangzhanglab@umich.edu   *
 *********************************************************************

Name of Chain_1: /x/q{k}.pdb (to be superimposed onto Chain_2)
Name of Chain_2: /x/t{k}.pdb
Length of Chain_1: 6 residues
Length of Chain_2: 5 residues

Aligned length= 5, RMSD=   1.89, Seq_ID=n_identical/n_aligned= 0.050
TM-score= 0.46204 (if normalized by length of Chain_1, i.e., LN=6, d0=6.35)
TM-score= 0.53755 (if normalized by length of Chain_2, i.e., LN=5, d0=1.04)
(You should use TM-score normalized by length of the reference structure)

(":" denotes residue pairs of d <  5.0 Angstrom, "." denotes other aligned residues)
ACDEFG
 ::.::
-CDEFG

"""

TM2017_LINES = ["\n"] * 11 + [
    "Chain 1:  /x/a.pdb  Size= 6\n", "Chain 2:  /x/b.pdb  Size= 5\n",
    "\n", "\n", "\n",
    "Aligned length=    5, RMSD=   2.10, Seq_ID=n_identical/n_aligned= 0.4\n",
    "TM-score= 0.41234 (if normalized by length of Chain_1)\n",
    "TM-score= 0.51234 (if normalized by length of Chain_2)\n",
    "\n", "\n", "\n", "\n",
    "ACDEFG\n", " :: ..\n", "AC-EFG\n"]


def test_tm_align_blocks_match_jax():
    lines = [ln + "\n" for ln in TM2021_BLOCK.format(k=0).split("\n")]
    assert tparsers.validate_block_2021(lines) == \
        jparsers.validate_block_2021(lines) is True
    assert tparsers.validate_block_2021(lines[:5]) == \
        jparsers.validate_block_2021(lines[:5])
    assert tparsers.parse_block_2021(lines) == \
        jparsers.parse_block_2021(lines)
    assert tparsers.parse_block_2017(TM2017_LINES) == \
        jparsers.parse_block_2017(TM2017_LINES)
    for z in ("A:B", "-.B", "A.-", "A B"):
        assert tparsers.aln_f(z) == jparsers.aln_f(z)


def test_parse_tm_align_file_matches_jax(tmp_path):
    """Three blocks at the 23-line stride, one behind a junk line (the
    parser's resync); the TSV output byte for byte."""
    text = []
    for k in range(3):
        lines = TM2021_BLOCK.format(k=k).split("\n")
        lines += [""] * (23 - len(lines))
        if k == 1:
            text.append("junk")
        text += lines
    f = tmp_path / "tm.txt"
    f.write_text("\n".join(text) + "\n")
    got = tparsers.parse_tm_align_file(str(f), str(tmp_path / "t.tsv"))
    want = jparsers.parse_tm_align_file(str(f), str(tmp_path / "j.tsv"))
    assert got == want.to_dict("records") and len(got) == 3
    assert (tmp_path / "t.tsv").read_bytes() == \
        (tmp_path / "j.tsv").read_bytes()


@pytest.mark.skipif(shutil.which("gzip") is None, reason="needs gzip")
def test_tm_align_batch_matches_jax(tmp_path):
    """The TMalign fan-out with a stand-in ``TMalign`` that prints the
    first bytes of the two unpacked files."""
    root = tmp_path / "pdb"
    for pid in ("1abc", "2xyz", "3def"):
        d = root / pid[1:-1]
        d.mkdir(parents=True, exist_ok=True)
        (d / f"pdb{pid}.ent").write_text(f"HEADER {pid}\n")
        subprocess.run(["gzip", str(d / f"pdb{pid}.ent")], check=True)
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("1ABC 2XYZ\n2xyz 3def\n")
    tm = tmp_path / "TMalign"
    tm.write_text('#!/bin/sh\nhead -c 11 "$1"; head -c 11 "$2"\n')
    tm.chmod(0o755)
    scratch = tmp_path / "scratch"
    scratch.mkdir()
    for mod, name in ((tparsers, "t.out"), (jparsers, "j.out")):
        mod.tm_align_batch(str(pairs), str(tmp_path / name), str(root),
                           num_jobs=1, tmalign_bin=str(tm),
                           scratch=str(scratch))
    assert (tmp_path / "t.out").read_text() == \
        (tmp_path / "j.out").read_text() == \
        "HEADER 1abcHEADER 2xyzHEADER 2xyzHEADER 3def"


def mali_tree(tmp_path):
    """Two Malidup-like pair directories: ``.ali`` files of several tools,
    single-structure PDBs (3 in one, 1 in the other), Mammoth output."""
    for name, x, y, pdbs in (("pair1", "AC-DE", "A-GDE", 3),
                             ("pair2", "MK--LV", "MKQQ-V", 1)):
        d = tmp_path / name
        d.mkdir()
        (d / f"d{name}.manual.ali").write_text(f"{x}\n{y}\n")
        (d / f"d{name}.manual2.ali").write_text(f"{x}\n{x}\n")
        (d / f"d{name}.dali.ali").write_text(f"{y}\n{x}\n")
        for i in range(pdbs):
            (d / f"d{name}_{i}.pdb").write_text("TER\n")
        (d / f"d{name}.manual.pdb").write_text("TER\n")
        (d / f"d{name}.mammoth.ali").write_text(
            f"Prediction {x.replace('-', '.')}\nPrediction xx\n"
            f"Experiment {y}\nExperiment {y.replace('-', '.')}\n")
    return str(tmp_path)


@pytest.mark.parametrize("report_ids", [False, True])
def test_read_mali_matches_jax(tmp_path, report_ids):
    root = mali_tree(tmp_path)
    for tool in ("manual", "dali"):
        got = tparsers.read_mali(root, tool, report_ids)
        want = jparsers.read_mali(root, tool, report_ids)
        assert got == records(want) and len(got) == 2
        if report_ids:
            assert list(got[0]) == list(want.columns)
            assert any(r["pdb_2"] is None for r in got)
    got = tparsers.read_mali_mammoth(root, report_ids)
    assert got == records(jparsers.read_mali_mammoth(root, report_ids))
    assert tparsers.read_mali(str(tmp_path / "pair1" / "none")) == [] and \
        jparsers.read_mali(str(tmp_path / "pair1" / "none")).empty


def test_get_mali_structure_stats_matches_jax(tmp_path):
    """Ragged rows: a helix's classes and a strand's (coil only)."""
    d = tmp_path / "pair1"
    d.mkdir()
    write_pdb(str(d / "d1a2b.manual.pdb"),
              jdssp.build_backbone([(-57.0, -47.0)] * 12))
    write_pdb(str(d / "d1a2c.manual.pdb"),
              jdssp.build_backbone([(-139.0, 135.0)] * 9))
    write_pdb(str(d / "d1a2b.dali.pdb"),
              jdssp.build_backbone([(-57.0, -47.0)] * 12))
    got = tparsers.get_mali_structure_stats(str(tmp_path))
    want = jparsers.get_mali_structure_stats(str(tmp_path))
    assert got == records(want) and len(got) == 2
    assert list(got[1]) == list(want.columns)


BLAST_XML = """<?xml version="1.0"?>
<BlastOutput><BlastOutput_iterations>
<Iteration>
 <Iteration_query-def>0 first query</Iteration_query-def>
 <Iteration_hits>
 <Hit><Hit_def>0</Hit_def><Hit_hsps><Hsp>
   <Hsp_bit-score>99.0</Hsp_bit-score><Hsp_evalue>1e-30</Hsp_evalue>
   <Hsp_query-from>1</Hsp_query-from><Hsp_query-to>4</Hsp_query-to>
   <Hsp_hit-from>1</Hsp_hit-from><Hsp_hit-to>4</Hsp_hit-to>
   <Hsp_qseq>ACDE</Hsp_qseq><Hsp_hseq>ACDE</Hsp_hseq>
   <Hsp_midline>ACDE</Hsp_midline></Hsp></Hit_hsps></Hit>
 <Hit><Hit_def>2 second</Hit_def><Hit_hsps>
  <Hsp>
   <Hsp_bit-score>55.1</Hsp_bit-score><Hsp_evalue>1e-10</Hsp_evalue>
   <Hsp_query-from>1</Hsp_query-from><Hsp_query-to>4</Hsp_query-to>
   <Hsp_hit-from>2</Hsp_hit-from><Hsp_hit-to>5</Hsp_hit-to>
   <Hsp_qseq>AC-D</Hsp_qseq><Hsp_hseq>ACED</Hsp_hseq>
   <Hsp_midline>AC D</Hsp_midline>
  </Hsp>
  <Hsp>
   <Hsp_bit-score>60.0</Hsp_bit-score><Hsp_evalue>1e-12</Hsp_evalue>
   <Hsp_query-from>2</Hsp_query-from><Hsp_query-to>5</Hsp_query-to>
   <Hsp_hit-from>1</Hsp_hit-from><Hsp_hit-to>4</Hsp_hit-to>
   <Hsp_qseq>CDEF</Hsp_qseq><Hsp_hseq>C-EF</Hsp_hseq>
   <Hsp_midline>C EF</Hsp_midline>
  </Hsp></Hit_hsps></Hit>
 <Hit><Hit_def>3</Hit_def><Hit_hsps><Hsp>
   <Hsp_bit-score>20.0</Hsp_bit-score><Hsp_evalue>0.5</Hsp_evalue>
   <Hsp_query-from>1</Hsp_query-from><Hsp_query-to>2</Hsp_query-to>
   <Hsp_hit-from>1</Hsp_hit-from><Hsp_hit-to>2</Hsp_hit-to>
   <Hsp_qseq>AC</Hsp_qseq><Hsp_hseq>AC</Hsp_hseq>
   <Hsp_midline>AC</Hsp_midline></Hsp></Hit_hsps></Hit>
 </Iteration_hits>
</Iteration>
</BlastOutput_iterations></BlastOutput>"""

HMMER_TEXT = """# hmmsearch :: search profile(s) against a sequence database
Query:       0  [M=10]
Scores for complete sequences (score includes all domains):

Domain annotation for each sequence (and alignments):
>> 2  a hit
   #    score  bias  c-Evalue  i-Evalue hmmfrom  hmm to    alifrom  ali to    envfrom  env to     acc
 ---   ------ ----- --------- --------- ------- -------    ------- -------    ------- -------    ----
   1 !   45.2   0.1   1.2e-14   2.3e-12       1      10 []       3      12 ..       1      14 [.] 0.95
   2 ?    3.1   0.0      0.02      0.04       2       6 ..       20      24 ..      19      25 .. 0.80

  Alignments for each domain:
  == domain 1  score: 45.2 bits;  conditional E-value: 1.2e-14
           0   1 acdef.ghik 10
                 ac ef ghik
           2   3 ACxEFwGHIK 12
                 89******** PP

  == domain 2  score: 3.1 bits;  conditional E-value: 0.02
           0   2 cdef 6
                 c ef
           2  20 CwEF 24
                 8*** PP

>> 0  self
   #    score  bias  c-Evalue  i-Evalue hmmfrom  hmm to    alifrom  ali to    envfrom  env to     acc
 ---   ------ ----- --------- --------- ------- -------    ------- -------    ------- -------    ----
   1 !   90.0   0.1   1.2e-30   2.3e-28       1      10 []       1      10 ..       1      10 [.] 0.99

  Alignments for each domain:
  == domain 1  score: 90.0 bits;  conditional E-value: 1.2e-30
           0   1 acdefghik 9
                 acdefghik
           0   1 ACDEFGHIK 9
                 ********* PP

//
"""


def test_blast_and_hmmer_match_jax(tmp_path):
    """Both parsers, their top hits among the manual Malidup pairs (ids
    0 -> 2 is a manual pair of ``mali_tree``'s two) and their state
    strings."""
    (tmp_path / "mali").mkdir()
    root = mali_tree(tmp_path / "mali")
    xml = tmp_path / "b.xml"
    xml.write_text(BLAST_XML)
    txt = tmp_path / "h.txt"
    txt.write_text(HMMER_TEXT)
    got = tparsers.parse_blast_xml(str(xml))
    assert got == jparsers.parse_blast_xml(str(xml)).to_dict("records")
    assert len(got) == 3
    got = tparsers.parse_hmmer_text(str(txt))
    assert got == jparsers.parse_hmmer_text(str(txt)).to_dict("records")
    assert len(got) == 2
    for t, j, path in ((tparsers.get_blast_alignments,
                        jparsers.get_blast_alignments, xml),
                       (tparsers.get_hmmer_alignments,
                        jparsers.get_hmmer_alignments, txt)):
        got = t(str(path), root)
        assert got == j(str(path), root).to_dict("records")
        assert len(got) == 1 and got[0]["aln"]


def test_parse_fatcat_ids_matches_jax():
    lines = ["d1abcA_ d2xyzB_ 1.0", "x:1qrsC1 x:4tuvD2 0.5"]
    assert tparsers.parse_fatcat_ids(lines) == \
        jparsers.parse_fatcat_ids(lines).to_dict("records")


# ---------------------------------------------------------------------------
# substitution and simulation
# ---------------------------------------------------------------------------

def test_blosum62_matches_jax():
    assert same(tsub.BLOSUM62, jsub.BLOSUM62)
    assert same(tsub.BLOSUM62_FREQS, jsub.BLOSUM62_FREQS)
    assert tsub.AA20 == jsub.AA20
    for alphabet in (tsub.AA20, "WAX"):
        assert same(tsub.blosum62_matrix(alphabet),
                    jsub.blosum62_matrix(alphabet))
    assert same(tsub.substitution_theta("AWQXZ", "WAE"),
                jsub.substitution_theta("AWQXZ", "WAE"))
    assert same(tsub.hmm_state_emissions(2.0), jsub.hmm_state_emissions(2.0))
    assert tsub.sample_hmm_sequences(5, seed=9) == \
        jsub.sample_hmm_sequences(5, seed=9)


@pytest.mark.parametrize("name", ["simulate_blosum_pairs",
                                  "simulate_hmm_pairs"])
def test_simulated_pairs_match_jax(name):
    got = getattr(tsub, name)(12, seed=3)
    want = getattr(jsub, name)(12, seed=3)
    assert got == want.values.tolist()
    ds_t = tdataset.TMAlignDataset(got)
    ds_j = jdataset.TMAlignDataset(want)
    assert len(ds_t) == len(ds_j) == 12
    assert same(ds_t[5], ds_j[5])


@pytest.mark.parametrize("ai,aj", [
    ("MQCP...ICKKDYS....TYSHLKKHMSR..H", "HVCKISYYCDEAYGKNDGSSYGLVEHLEKENH"),
    ("FKCD...NCKKVYD....SYKSMKEHLNA..H", "MQCP...ICKKDYS....TYSHLKKHMSR..H"),
])
def test_parse_alignment_matches_jax(ai, aj):
    assert tsim.parse_alignment(ai, aj) == jsim.parse_alignment(ai, aj)


class _FakeProc:
    """Popen stand-in returning the canned ``hmmemit -a`` output."""

    def __init__(self, cmd, **kw):
        assert cmd == f"hmmemit -a -N 7 --seed 0 {HMM}", cmd
        with open(STO, "rb") as f:
            self.stdout = io.BytesIO(f.read())
        self.returncode = 0

    def wait(self):
        return 0


class _FailedProc(_FakeProc):
    def __init__(self, cmd, **kw):
        self.stdout = io.BytesIO(b"")
        self.returncode = 127


def test_hmm_alignments_match_jax(monkeypatch, tmp_path):
    """One ``random.seed``, the canned MSA in both packages: the same rows
    and the same TSV, byte for byte, through each package's CLI."""
    monkeypatch.setattr(tsim, "Popen", _FakeProc)
    monkeypatch.setattr(jsim, "Popen", _FakeProc)
    random.seed(4)
    got = tsim.hmm_alignments(7, 0, 12, HMM)
    random.seed(4)
    want = jsim.hmm_alignments(7, 0, 12, HMM)
    assert [list(r) for r in got] == want.values.tolist()
    argv = ["--hmmfile", HMM, "--n-sequences", "7", "--n-alignments", "9",
            "--seed", "0", "--output-file"]
    random.seed(11)
    assert thmm_cli.main(argv + [str(tmp_path / "t.tsv")]) == 0
    random.seed(11)
    assert jhmm_cli.main(argv + [str(tmp_path / "j.tsv")]) == 0
    assert (tmp_path / "t.tsv").read_bytes() == \
        (tmp_path / "j.tsv").read_bytes()
    assert len((tmp_path / "t.tsv").read_text().splitlines()) == 9
    monkeypatch.setattr(tsim, "Popen", _FailedProc)
    with pytest.raises(RuntimeError, match="hmmemit failed"):
        tsim.hmm_alignments(7, 0, 2, HMM)


def test_make_hmm_data_matches_jax():
    assert same(tsim.make_hmm_data(12), jsim.make_hmm_data(12))


# ---------------------------------------------------------------------------
# MaliAlignmentDataset and batching
# ---------------------------------------------------------------------------

def test_mali_alignment_dataset_matches_jax():
    """Items and batches of gapped pairs: tuples (or rows keyed 0 and 1)
    in the port, the JAX frame of the same pairs."""
    rng = np.random.default_rng(2)
    pairs = []
    for _ in range(7):
        st = _random_states(rng, int(rng.integers(8, 30)), 0.3)
        x = "".join("-" if s == "2" else rng.choice(list("ACDEFGHIK"))
                    for s in st)
        y = "".join("-" if s == "1" else rng.choice(list("ACDEFGHIK"))
                    for s in st)
        pairs.append((x, y))
    ds_t = tdataset.MaliAlignmentDataset(pairs)
    ds_j = jdataset.MaliAlignmentDataset(pd.DataFrame(pairs))
    assert same(ds_t.lengths(), ds_j.lengths())
    for i in range(len(pairs)):
        assert same(ds_t[i], ds_j[i])
    for shuffle in (True, False):
        kw = dict(shuffle=shuffle, seed=3, pad_multiple=4)
        got = list(tdataset.make_batches(ds_t, 3, **kw))
        want = list(jdataset.make_batches(ds_j, 3, **kw))
        assert same(got, want)
    gapped = [("AC-DE", "A-GDE"), ("MK--LV", "MKQQ-V")]
    assert same(tdataset.MaliAlignmentDataset(
        [{0: x, 1: y} for x, y in gapped])[1],
        tdataset.MaliAlignmentDataset(gapped)[1])
    with pytest.raises(ValueError, match="gapped sequences"):
        tdataset.MaliAlignmentDataset([("AC-", "A")])[0]


def test_collate_names_match_jax():
    ds_t = tdataset.TMAlignDataset(TM_TAB, tm_threshold=0.0,
                                   return_names=True)
    ds_j = jdataset.TMAlignDataset(TM_TAB, tm_threshold=0.0,
                                   return_names=True)
    items_t = [ds_t[i] for i in (0, 3, 5)]
    items_j = [ds_j[i] for i in (0, 3, 5)]
    got = tdataset.collate(items_t, pad_multiple=8)
    assert same(got, jdataset.collate(items_j, pad_multiple=8))
    assert got["names"][0] == ("/scratch/pdb3itf.ent",
                               "/scratch/pdb2mce.ent")


# ---------------------------------------------------------------------------
# no pandas, no matplotlib
# ---------------------------------------------------------------------------

def test_port_imports_no_pandas_or_matplotlib():
    """The card's machine has neither: no module of the port (or
    ``chip_smoke.py``) imports them."""
    paths = [os.path.join(d, f)
             for d, _, fs in os.walk(os.path.join(REPO, "deepblast_torch"))
             for f in fs if f.endswith(".py")]
    for path in paths + [os.path.join(REPO, "chip_smoke.py")]:
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
                assert n.split(".")[0] not in ("pandas", "matplotlib"), \
                    (path, n)
