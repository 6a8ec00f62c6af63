"""A TM-align row's inputs worked out from its strings: ProtT5's token ids,
the true alignment as a 0/1 matrix and its gap mask.

ProtT5's vocabulary (``Rostlab/prot_t5_xl_uniref50``'s ``spiece``): pad 0,
``</s>`` 1, unknown 2, then ``A L G V S R E D T I P K F Q N Y M H W C X``
from 3; DeepBLAST feeds the residues without an end token.  The state
string walks the matrix: ``1`` a residue of x alone, ``2`` of y alone,
any other character (TM-align's ``:`` and ``.``) an aligned pair; state
``t`` sits at row ``#(not 2) - 1`` and column ``#(not 1) - 1`` of its
prefix (clipped at 0); the gap mask keeps the cells of ``:`` states, and
cell ``(0, 0)``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["tokens", "alignment"]

_ORDER = "ALGVSREDTIPKFQNYMHWCX"


def tokens(seq):
    return np.array([3 + _ORDER.index(c) if c in _ORDER else 2 for c in seq],
                    np.int64)


def alignment(n, m, states):
    """``(target, gmask)`` ``(n, m)`` of a state string."""
    s = np.array(list(states))
    i = np.maximum(np.cumsum(s != "2") - 1, 0)
    j = np.maximum(np.cumsum(s != "1") - 1, 0)
    target = np.zeros((n, m), np.float32)
    target[i, j] = 1.0
    keep = s == ":"
    keep[0] = True
    gmask = np.zeros((n, m), bool)
    gmask[i[keep], j[keep]] = True
    return target, gmask
