"""Sequence alphabets and tokenizers (own copy of
``deepblast_tpu/data/alphabet.py``).

* :class:`Alphabet`, :class:`Uniprot21`, :class:`UniprotTokenizer` and
  :class:`UniprotPairTokenizer` (``alphabet.py:36-122``) — the Bepler
  21-letter alphabet (OUBZ fold onto synonyms, a missing letter is 20),
  the ids of the BiLM's embedding table; ``pad_ends`` flanks a sequence
  with 20.
* :class:`ProtT5Tokenizer` (``alphabet.py:125-182``) — single-residue
  tokenizer for ProtT5-style encoders: uppercase, ``[UZOB] -> X``, one
  token per residue, optional ``</s>`` terminator.  It reads the
  sentencepiece vocab ordering from a local HF asset when given, else uses
  the built-in residue table; either way it needs no sentencepiece,
  because the protein vocab is single-character.

The trainer's tokenizers (:class:`ProtT5Tokenizer`,
:class:`UniprotPairTokenizer`) return ``(ids int32, ones mask)``.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np

__all__ = ["Alphabet", "Uniprot21", "UniprotTokenizer",
           "UniprotPairTokenizer", "ProtT5Tokenizer", "TOKENIZERS"]


class Alphabet:
    """Byte-table codec with k-mer unpacking."""

    def __init__(self, chars: bytes, encoding=None, mask=False, missing=255):
        self.chars = np.frombuffer(chars, dtype=np.uint8)
        self.encoding = np.full(256, missing, dtype=np.uint8)
        if encoding is None:
            self.encoding[self.chars] = np.arange(len(self.chars))
            self.size = len(self.chars)
        else:
            self.encoding[self.chars] = encoding
            self.size = int(encoding.max()) + 1
        self.mask = mask
        if mask:
            self.size -= 1

    def __len__(self):
        return self.size

    def __getitem__(self, i):
        return chr(self.chars[i])

    def encode(self, x: bytes) -> np.ndarray:
        return self.encoding[np.frombuffer(x, dtype=np.uint8)]

    def decode(self, x) -> bytes:
        return self.chars[np.asarray(x, dtype=np.int64)].tobytes()

    def unpack(self, h: int, k: int) -> np.ndarray:
        n = self.size
        kmer = np.zeros(k, dtype=np.uint8)
        for i in reversed(range(k)):
            kmer[i] = h % n
            h //= n
        return kmer

    def get_kmer(self, h: int, k: int) -> bytes:
        return self.decode(self.unpack(h, k))


class Uniprot21(Alphabet):
    """21-letter protein alphabet; OUBZ collapse onto synonyms, missing=20."""

    def __init__(self, mask=False):
        chars = b"ARNDCQEGHILKMFPSTWYVXOUBZ"
        encoding = np.arange(len(chars))
        encoding[21:] = [11, 4, 20, 20]
        super().__init__(chars, encoding=encoding, mask=mask, missing=20)


class UniprotTokenizer:
    """``tokenizer(seq) -> uint8 ids``, upper-cased first; with
    ``pad_ends`` flanked by the missing id 20."""

    def __init__(self, pad_ends=False):
        self.alphabet = Uniprot21()
        self.pad_ends = pad_ends

    def __call__(self, x) -> np.ndarray:
        if isinstance(x, str):
            x = x.encode()
        z = self.alphabet.encode(bytes(x).upper())
        if self.pad_ends:
            out = np.full(len(z) + 2, 20, dtype=z.dtype)
            out[1:-1] = z
            return out
        return z

    def decode(self, ids) -> str:
        """Token ids -> residue string."""
        return self.alphabet.decode(
            np.asarray(ids, np.uint8)).decode("ascii")


class UniprotPairTokenizer(UniprotTokenizer):
    """:class:`UniprotTokenizer` with the trainer's calling convention,
    ``(ids int32, ones mask)``: the tokenizer of a Bepler-alphabet BiLM
    artifact, whose embedding table covers the Uniprot21 ids and the mask
    token, not ProtT5's sentencepiece ids."""

    def __call__(self, x):
        ids = np.asarray(super().__call__(x), np.int32)
        return ids, np.ones_like(ids)

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


#: the trainer's tokenizers by the name ``config.json`` records
TOKENIZERS = {"prot_t5": ProtT5Tokenizer, "uniprot": UniprotPairTokenizer}
