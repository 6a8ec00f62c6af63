"""The traffic generator: the same seed gives the same inputs, every seed
the same sizes, and the rows are ones the program's dataset takes."""

import math

import numpy as np
import pytest
import torch

from portbench import manifest, traffic
from portbench.reference import tmalign

SEEDS = (0, 7, 2**31 + 5, 2**40 + 3)


@pytest.mark.parametrize("mix", ["fit-tmalign", "align-tmalign"])
def test_pair_rows_repeat_and_share_sizes(mix):
    m = manifest.mix(mix)
    m["pairs"]["count"] = 48
    runs = {s: traffic.pair_rows(m, s) for s in SEEDS}
    assert traffic.pair_rows(m, SEEDS[2]) == runs[SEEDS[2]]
    sizes = {tuple(sorted((len(r[5]), len(r[6])) for r in rows))
             for rows in runs.values()}
    assert len(sizes) == 1
    assert runs[SEEDS[0]] != runs[SEEDS[1]]


def test_pair_rows_are_whole_alignments():
    from deepblast_torch.data.dataset import TMAlignDataset
    m = manifest.mix("fit-tmalign")
    m["pairs"]["count"] = 64
    rows = traffic.pair_rows(m, 11)
    ds = TMAlignDataset(rows)
    assert len(ds) == len(rows)
    for k, r in enumerate(rows):
        x, y, st = r[5], r[6], r[7]
        assert st[0] == ":" and st[-1] == ":"
        aligned = st.count(":") + st.count(".")
        assert st.count("1") + aligned == len(x)
        assert st.count("2") + aligned == len(y)
        assert aligned == max(2, round(m["pairs"]["aligned"]
                                       * min(len(x), len(y))))
        assert max(len(x), len(y)) <= m["pairs"]["lengths"]["max"]
        item = ds[k]
        target, gmask = tmalign.alignment(len(x), len(y), st)
        assert np.array_equal(item["aln"], target)
        assert np.array_equal(item["gmask"], gmask)
        assert np.array_equal(item["x"], tmalign.tokens(x))


def test_grid_lengths():
    spec = {"median": 300, "sigma": 0.5, "min": 1, "max": 10**6}
    n = traffic.grid_lengths(spec, 256)
    assert n == sorted(n) and n[127] <= 300 <= n[128]
    cut = traffic.grid_lengths(dict(spec, min=50, max=300), 256)
    assert cut == sorted(cut) and cut[0] >= 50 and cut[-1] <= 300
    # the truncated grid's median is the full one's lower quartile
    assert abs(cut[128] - 300 * math.exp(0.5 * -0.6745)) <= 2


def test_batches_have_the_same_shapes_for_every_seed():
    """``make_batches`` sorts by the longer chain after a seeded shuffle:
    no two pairs of another shape share a longer chain across a batch's
    edge, so every seed's batches pad to the same shapes."""
    m = manifest.mix("fit-tmalign")
    lengths = traffic.pair_lengths(m["pairs"])
    longer = sorted(max(p) for p in lengths)
    bs = m["batch_size"]
    for edge in range(bs, len(longer), bs):
        if longer[edge - 1] == longer[edge]:
            tied = {p for p in lengths if max(p) == longer[edge]}
            assert len(tied) == 1, (edge, tied)


def test_pairs_follow_the_fixture_they_were_fitted_to():
    """The mixes' lengths and alignment shares are the fit to the PDB
    chains of DeepBLAST's TM-align fixture (``tests/data``)."""
    import os
    import statistics
    path = os.path.join(manifest.ROOT, "tests", "data", "test_tm_align.tab")
    rows = [line.rstrip("\n").split("\t") for line in open(path)]
    logs = [math.log(len(r[k])) for r in rows for k in (5, 6)]
    aligned = [(r[7].count(":") + r[7].count(".")) / min(len(r[5]), len(r[6]))
               for r in rows]
    close = [r[7].count(":") / (r[7].count(":") + r[7].count("."))
             for r in rows]
    for name in ("fit-tmalign", "align-tmalign"):
        p = manifest.mix(name)["pairs"]
        spec = p["lengths"]
        assert spec["median"] == round(math.exp(statistics.mean(logs)), 1)
        assert spec["sigma"] == round(statistics.stdev(logs), 3)
        assert spec["min"] == min(len(r[k]) for r in rows for k in (5, 6))
        assert p["aligned"] == round(statistics.median(aligned), 3)
        assert p["close"] == round(statistics.median(close), 3)


@pytest.mark.parametrize("mix", ["train-800", "train-4096"])
def test_potentials_repeat_and_are_paths(mix):
    m = manifest.mix(mix)
    m["potentials"].update(batch=3, n=17, m=13)
    a = traffic.potentials(m, 2**33 + 1, torch.device("cpu"))
    b = traffic.potentials(m, 2**33 + 1, torch.device("cpu"))
    for k in a:
        assert torch.equal(a[k], b[k])
    assert (a["theta"] > 0).all() and (a["A"] < 0).all()
    for p in range(3):
        aln = a["aln"][p]
        assert aln[0, 0] == 1 and aln[-1, -1] == 1
        i, j = torch.nonzero(aln, as_tuple=True)
        steps = torch.stack([i.diff(), j.diff()], 1)
        assert ((steps >= 0).all(1) & (steps <= 1).all(1)
                & (steps.sum(1) >= 1)).all()
        assert a["gmask"][p].le(aln.bool()).all()
