"""Datasets and batching (own copies of
``deepblast_tpu/data/dataset.py``), without pandas.

:class:`TMAlignDataset` reads the 8-column TM-align TSV with ``csv`` (or
takes a list of row tuples); :class:`MaliAlignmentDataset` takes gapped
pairs (Malidup/Malisam); :func:`collate` pads items into one batch and
:func:`make_batches` shuffles and length-buckets with numpy's
``default_rng(seed)``, in the JAX package's order.  :class:`FastaDataset`
streams query x database pairs for search.
"""

from __future__ import annotations

import csv
import math

import numpy as np

from deepblast_torch.data.alphabet import ProtT5Tokenizer, UniprotTokenizer
from deepblast_torch.data.state_utils import (
    clip_boundaries,
    gap_mask,
    path_distance_matrix,
    state_f,
    states2edges,
    states2matrix,
    tmstate_f,
)

__all__ = [
    "TM_COLUMNS",
    "TMAlignDataset",
    "MaliAlignmentDataset",
    "FastaDataset",
    "read_fasta",
    "collate",
    "make_batches",
]

TM_COLUMNS = [
    "chain1_name", "chain2_name", "tmscore1", "tmscore2", "rmsd",
    "chain1", "chain2", "alignment",
]


def _reshape(mat, N, M):
    """Orient a matrix as (N, M), transposing if needed."""
    if mat.shape != (N, M) and mat.shape != (M, N):
        raise ValueError(f"The shape of `x` {mat.shape} "
                         f"does not agree with ({N}, {M})")
    return mat if mat.shape == (N, M) else mat.T


def _read_rows(path):
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter="\t") if r]
    for r in rows:
        if len(r) != len(TM_COLUMNS):
            raise ValueError(f"{path}: expected {len(TM_COLUMNS)} "
                             f"tab-separated columns, got {len(r)}")
    return rows


class TMAlignDataset:
    """TM-align pairs (8 columns in ``TM_COLUMNS`` order), from a TSV path
    or a list of row tuples.  Pairs with ``max(tmscore1, tmscore2) <=
    tm_threshold`` or a chain of ``max_len`` or more residues are dropped.
    Items have leading and trailing gaps clipped and the gap mask of the
    confident (``:``) cells; ``construct_paths`` fills ``path`` with each
    cell's distance to the alignment path (else zeros); ``return_names``
    adds ``names`` (the two chain names) and ``seqs`` (the two clipped
    sequences)."""

    def __init__(self, path, tokenizer=None, tm_threshold=0.4, max_len=1024,
                 return_names=False, construct_paths=False):
        self.tokenizer = tokenizer or ProtT5Tokenizer()
        rows = _read_rows(path) if isinstance(path, str) else list(path)
        self.pairs = []
        for r in rows:
            rec = dict(zip(TM_COLUMNS, r))
            tm = max(float(rec["tmscore1"]), float(rec["tmscore2"]))
            length = max(len(rec["chain1"]), len(rec["chain2"]))
            if tm > tm_threshold and length < max_len:
                self.pairs.append(rec)
        self.return_names = return_names
        self.construct_paths = construct_paths

    def __len__(self):
        return len(self.pairs)

    def lengths(self):
        """Per-pair max sequence length, for length-bucketed batching."""
        return np.array([max(len(r["chain1"]), len(r["chain2"]))
                         for r in self.pairs], np.int64)

    def __getitem__(self, i):
        row = self.pairs[i]
        gene, pos, st = row["chain1"], row["chain2"], row["alignment"]
        states = [tmstate_f(s) for s in st]
        gene, pos, states, st = clip_boundaries(gene, pos, states, st)
        x_tok, _ = self.tokenizer(gene)
        y_tok, _ = self.tokenizer(pos)
        states = np.asarray(states, np.int32)
        aln = states2matrix(states)
        lg, lp = len(gene), len(pos)
        aln = _reshape(aln, lg, lp).astype(np.float32)
        if self.construct_paths:
            path = _reshape(
                path_distance_matrix(states2edges(states)), lg, lp)
        else:
            path = np.zeros((lg, lp), np.float32)
        g = _reshape(gap_mask(st), lg, lp)
        item = dict(x=x_tok, y=y_tok, states=states,
                    aln=aln, path=path.astype(np.float32), gmask=g)
        if self.return_names:
            item["names"] = (row["chain1_name"], row["chain2_name"])
            item["seqs"] = (gene, pos)
        return item


class MaliAlignmentDataset:
    """Gapped pairs (Malidup/Malisam): ``pairs`` is a list of rows whose
    items 0 and 1 are the two gapped sequences of one alignment (tuples,
    or mappings keyed 0 and 1).  Items have
    the Uniprot21 ids (``UniprotTokenizer`` by default) of the ungapped
    sequences, the states, the alignment matrix, a zero ``path`` and an
    all-ones gap mask."""

    def __init__(self, pairs, tokenizer=None):
        self.pairs = list(pairs)
        self.tokenizer = tokenizer or UniprotTokenizer()

    def __len__(self):
        return len(self.pairs)

    def lengths(self):
        """Per-pair max ungapped sequence length (batching sort key)."""
        return np.array([
            max(len(str(r[0]).replace("-", "")),
                len(str(r[1]).replace("-", "")))
            for r in self.pairs], np.int64)

    def __getitem__(self, i):
        gene, pos = self.pairs[i][0], self.pairs[i][1]
        if len(gene) != len(pos):
            raise ValueError(f"pair {i}: gapped sequences of lengths "
                             f"{len(gene)} and {len(pos)}")
        states = np.asarray(
            [state_f(z) for z in zip(gene, pos)], np.int32)
        aln = states2matrix(states).astype(np.float32)
        x_tok = np.asarray(self.tokenizer(gene.replace("-", "")), np.int32)
        y_tok = np.asarray(self.tokenizer(pos.replace("-", "")), np.int32)
        lg, lp = len(gene.replace("-", "")), len(pos.replace("-", ""))
        aln = _reshape(aln, lg, lp)
        return dict(x=x_tok, y=y_tok, states=states, aln=aln,
                    path=np.zeros_like(aln), gmask=np.ones_like(aln, bool))


def read_fasta(path):
    """Minimal FASTA reader yielding ``(id, sequence)``."""
    name, chunks = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


class FastaDataset:
    """Streams query x database pairs, database-major."""

    def __init__(self, query_file, db_file, tokenizer=None):
        self.tokenizer = tokenizer or ProtT5Tokenizer()
        self.query_file = query_file
        self.db_file = db_file

    def __iter__(self):
        for dbid, dbseq in read_fasta(self.db_file):
            db_tok, _ = self.tokenizer(dbseq)
            for qid, qseq in read_fasta(self.query_file):
                q_tok, _ = self.tokenizer(qseq)
                yield dict(qid=qid, dbid=dbid,
                           x=np.asarray(q_tok, np.int32),
                           y=np.asarray(db_tok, np.int32))


def _bucket(n, multiple):
    return int(math.ceil(n / multiple) * multiple)


def collate(items, pad_multiple=1):
    """Pad a list of dataset items into one fixed-shape batch dict:
    ``x, y (B, Lx|Ly) int32``, ``x_len, y_len (B,)``, ``aln, path
    (B, Lx, Ly) float32``, ``gmask (B, Lx, Ly) bool``, the ragged
    ``states`` list for host-side evaluation and, where the items have
    them, the ``names`` and ``seqs`` lists."""
    B = len(items)
    xl = np.array([len(it["x"]) for it in items], np.int32)
    yl = np.array([len(it["y"]) for it in items], np.int32)
    Lx = _bucket(int(xl.max()), pad_multiple)
    Ly = _bucket(int(yl.max()), pad_multiple)
    x = np.zeros((B, Lx), np.int32)
    y = np.zeros((B, Ly), np.int32)
    aln = np.zeros((B, Lx, Ly), np.float32)
    path = np.zeros((B, Lx, Ly), np.float32)
    g = np.zeros((B, Lx, Ly), bool)
    for b, it in enumerate(items):
        n, mm = xl[b], yl[b]
        x[b, :n] = it["x"]
        y[b, :mm] = it["y"]
        aln[b, :n, :mm] = it["aln"]
        path[b, :n, :mm] = it["path"]
        g[b, :n, :mm] = it["gmask"]
    batch = dict(x=x, y=y, x_len=xl, y_len=yl, aln=aln, path=path,
                 gmask=g, states=[it["states"] for it in items])
    if "names" in items[0]:
        batch["names"] = [it["names"] for it in items]
        batch["seqs"] = [it["seqs"] for it in items]
    return batch


def make_batches(dataset, batch_size, shuffle=True, seed=0, pad_multiple=16,
                 drop_last=False):
    """Yield collated batches of a dataset: shuffle, stable sort by length,
    cut into ``batch_size`` chunks (with ``drop_last``, without a last
    short one), shuffle the chunks."""
    idx = np.arange(len(dataset))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(idx)
    lens = dataset.lengths()[idx]
    if lens.any():
        idx = idx[np.argsort(lens, kind="stable")]
    chunks = [idx[i:i + batch_size] for i in range(0, len(idx), batch_size)]
    if drop_last and chunks and len(chunks[-1]) < batch_size:
        chunks = chunks[:-1]
    if shuffle:
        rng.shuffle(chunks)
    for chunk in chunks:
        yield collate([dataset[int(i)] for i in chunk],
                      pad_multiple=pad_multiple)
