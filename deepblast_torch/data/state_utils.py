"""Alignment-state helpers (own copies from
``deepblast_tpu/data/state_utils.py`` and ``deepblast_tpu/constants.py``).

States are (x, m, y) = (0, 1, 2): ``x`` consumes a residue of the first
sequence, ``m`` is a match, ``y`` consumes a residue of the second.  The
TM-align text form writes them ``1``, ``:`` and ``2``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["x", "m", "y", "revstate_f", "pad_sequences"]

x, m, y = 0, 1, 2


def revstate_f(z):
    """State -> TM-align character."""
    if z == x:
        return "1"
    if z == y:
        return "2"
    if z == m:
        return ":"


def pad_sequences(seqs, pad_value=0, dtype=None):
    """Stack variable-length 1-D arrays into a padded matrix + lengths."""
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    L = int(lengths.max()) if len(seqs) else 0
    dtype = dtype or np.asarray(seqs[0]).dtype
    out = np.full((len(seqs), L), pad_value, dtype=dtype)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out, lengths
