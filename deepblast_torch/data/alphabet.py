"""ProtT5 tokenizer (own copy of ``deepblast_tpu/data/alphabet.py:125-182``).

Single-residue tokenizer for ProtT5-style encoders: uppercase,
``[UZOB] -> X``, one token per residue, optional ``</s>`` terminator.  It
reads the sentencepiece vocab ordering from a local HF asset when given,
else uses the built-in residue table; either way it needs no
sentencepiece, because the protein vocab is single-character.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

__all__ = ["ProtT5Tokenizer"]

# Default id layout matching the Rostlab ProtT5 sentencepiece vocab:
# 0: <pad>, 1: </s>, 2: <unk>, 3..: residues by training-corpus frequency.
_PROT_T5_RESIDUE_ORDER = "ALGVSREDTIPKFQNYMHWC"  # then X


class ProtT5Tokenizer:
    """``tokenizer(seq) -> (ids int32, ones mask)``; ``decode(ids) -> str``."""

    PAD, EOS, UNK = 0, 1, 2

    def __init__(self, vocab_file=None, add_eos=False):
        self.add_eos = add_eos
        if vocab_file and os.path.exists(vocab_file):
            self.vocab = self._load_vocab(vocab_file)
        else:
            self.vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
            for i, ch in enumerate(_PROT_T5_RESIDUE_ORDER + "X"):
                self.vocab[ch] = 3 + i
        self.inv_vocab = {v: k for k, v in self.vocab.items()}

    @staticmethod
    def _load_vocab(path):
        """Token order from a HF tokenizer.json / vocab json asset."""
        with open(path) as f:
            obj = json.load(f)
        if isinstance(obj, dict) and "model" in obj:   # tokenizer.json
            vocab = obj["model"]["vocab"]
            if isinstance(vocab, list):                # sentencepiece pieces
                vocab = {tok: i for i, (tok, _) in enumerate(vocab)}
        else:
            vocab = obj
        return {k.replace("▁", ""): v for k, v in vocab.items()}

    def __call__(self, seq: str):
        seq = re.sub(r"[UZOB]", "X", seq.upper())
        ids = [self.vocab.get(c, self.UNK) for c in seq]
        if self.add_eos:
            ids.append(self.EOS)
        ids = np.asarray(ids, dtype=np.int32)
        return ids, np.ones_like(ids)

    def decode(self, ids) -> str:
        out = []
        for i in np.asarray(ids).tolist():
            tok = self.inv_vocab.get(int(i), "")
            if tok in ("<pad>", "</s>", "<unk>"):
                continue
            out.append(tok)
        return "".join(out)
