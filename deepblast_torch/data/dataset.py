"""FASTA input for search (own copies of ``read_fasta`` and
``FastaDataset`` from ``deepblast_tpu/data/dataset.py:154-189``)."""

from __future__ import annotations

import numpy as np

from deepblast_torch.data.alphabet import ProtT5Tokenizer

__all__ = ["read_fasta", "FastaDataset"]


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
