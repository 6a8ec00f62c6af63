"""Alignment-state helpers (own copies from
``deepblast_tpu/data/state_utils.py:38-274`` and
``deepblast_tpu/constants.py``).

States are (x, m, y) = (0, 1, 2): ``x`` consumes a residue of the first
sequence, ``m`` is a match, ``y`` consumes a residue of the second.  The
TM-align text form writes them ``1``, ``:`` (or ``.``) and ``2``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "x",
    "m",
    "y",
    "NUM_STATES",
    "STATE_CHARS",
    "state_f",
    "tmstate_f",
    "revstate_f",
    "states2edges",
    "states2matrix",
    "states2alignment",
    "clip_boundaries",
    "gap_mask",
    "path_distance_matrix",
    "remove_orphans",
    "trim_gap_span",
    "trim_gap",
    "pad_sequences",
    "decode_tokens",
]

x, m, y = 0, 1, 2

#: Number of DP states.
NUM_STATES = 3

#: Character rendering of the states.
STATE_CHARS = {x: "1", m: ":", y: "2"}


def state_f(z):
    """Gapped-pair characters -> state."""
    if z[0] == "-":
        return x
    if z[1] == "-":
        return y
    return m


def tmstate_f(z):
    """TM-align state character -> state."""
    if z == "1":
        return x
    if z == "2":
        return y
    return m


def revstate_f(z):
    """State -> TM-align character."""
    if z == x:
        return "1"
    if z == y:
        return "2"
    if z == m:
        return ":"


def states2edges(states):
    """State string -> list of ``(i, j)`` matrix coordinates along the path.

    Coordinates are consumption-based: state ``t`` sits at row
    ``(#x + #m so far) - 1`` and column ``(#y + #m so far) - 1`` (clipped
    at 0), so the matrix dims equal the ungapped sequence lengths (the JAX
    package's documented deviation from the reference walk)."""
    states = np.asarray(list(states))
    known = (states == x) | (states == m) | (states == y)
    if not known.all():
        bad = states[~known][0]
        raise ValueError(f"Unknown state code {bad!r} in state string.")
    ci = np.maximum(np.cumsum((states == x) | (states == m)) - 1, 0)
    cj = np.maximum(np.cumsum((states == y) | (states == m)) - 1, 0)
    return list(zip(ci.tolist(), cj.tolist()))


def states2matrix(states, sparse=False):
    """State string -> dense 0/1 alignment matrix."""
    coords = states2edges(states)
    rows, cols = np.array(coords).T
    N, M = rows.max() + 1, cols.max() + 1
    mat = np.zeros((N, M))
    mat[rows, cols] = 1.0
    if sparse:
        from scipy.sparse import coo_matrix
        return coo_matrix((np.ones(len(coords)), (rows, cols)),
                          shape=(N, M))
    return mat


def states2alignment(states, X: str, Y: str):
    """State string -> gapped sequence pair, with length validation."""
    if isinstance(states, str):
        states = np.array([tmstate_f(s) for s in states])
    states = np.asarray(states)
    sx = int(np.sum(states == x) + np.sum(states == m))
    sy = int(np.sum(states == y) + np.sum(states == m))
    if sx != len(X):
        raise ValueError(
            f"The state string length {sx} does not match "
            f"the length of sequence {len(X)}.\n"
            f"SequenceX: {X}\nSequenceY: {Y}\nStates: {states}\n")
    if sy != len(Y):
        raise ValueError(
            f"The state string length {sy} does not match "
            f"the length of sequence {len(Y)}.\n"
            f"SequenceX: {X}\nSequenceY: {Y}\nStates: {states}\n")
    ax, ay = [], []
    i = j = 0
    for s in states:
        if s == x:
            ax.append(X[i])
            ay.append("-")
            i += 1
        elif s == y:
            ax.append("-")
            ay.append(Y[j])
            j += 1
        elif s == m:
            ax.append(X[i])
            ay.append(Y[j])
            i += 1
            j += 1
        else:
            raise ValueError(f"{s} is not recognized")
    return "".join(ax), "".join(ay)


def clip_boundaries(X, Y, A, st):
    """Trim leading/trailing gap states from an alignment."""
    A = list(A)
    first = 0 if A[0] == m else A.index(m)
    last = len(A) if A[-1] == m else len(A) - A[::-1].index(m)
    gx, gy = states2alignment(np.array(A), X, Y)
    X_ = gx[first:last].replace("-", "")
    Y_ = gy[first:last].replace("-", "")
    return X_, Y_, A[first:last], st[first:last]


def gap_mask(states: str, sparse=False):
    """Mask of confident (``:``) alignment cells along the path; cell
    (0, 0) is always kept."""
    st = np.array([tmstate_f(s) for s in states])
    coords = np.array(states2edges(st))
    keep = np.array(list(states)) == ":"
    keep[0] = True
    rows, cols = coords.T
    N, M = rows.max() + 1, cols.max() + 1
    mat = np.zeros((N, M), dtype=bool)
    mat[rows[keep], cols[keep]] = True
    if sparse:
        from scipy.sparse import coo_matrix
        return coo_matrix(mat)
    return mat


def path_distance_matrix(pi):
    """Distance from every cell to the nearest path cell."""
    from scipy.spatial import cKDTree
    pi = np.asarray(pi)
    N = pi[:, 0].max() + 1
    M = pi[:, 1].max() + 1
    xs, ys = np.arange(N), np.arange(M)
    coords = np.dstack(np.meshgrid(xs, ys)).reshape(-1, 2)
    d, _ = cKDTree(pi).query(coords)
    out = np.zeros((N, M))
    out[coords[:, 0], coords[:, 1]] = d
    return out


def _window(seq, n):
    for i in range(len(seq) - n + 1):
        yield tuple(seq[i:i + n])


def _replace_orphan(w, s):
    i = len(w) // 2
    sw = "".join(w)
    if w[i] == ":" and (("1" * s in sw[:i] and "1" * s in sw[i:])
                        or ("2" * s in sw[:i] and "2" * s in sw[i:])):
        return ["1", "2"]
    return [w[i]]


def remove_orphans(states: str, threshold: int = 11) -> str:
    """Replace a match orphaned inside long gaps (a run of ``threshold //
    2`` of one gap state on both sides within the window) by a gap pair
    ``12``; the ends are kept as the JAX package keeps them (one more
    state at the end than at the start)."""
    wins = list(_window(states, threshold))
    out = []
    for w in wins:
        out.extend(_replace_orphan(w, threshold // 2))
    out = list(states[:threshold // 2]) + out
    out += list(states[-threshold // 2 + 1:])
    return "".join(out)


def trim_gap_span(is_match, k=10):
    """Longest half-open span ``[i, j)`` of the alignment containing no run
    of ``k`` consecutive gaps, by one linear scan."""
    is_match = np.asarray(is_match).astype(bool)
    best_i = best_j = 0
    start = 0
    run = 0
    for idx, v in enumerate(is_match):
        run = 0 if v else run + 1
        if run >= k:
            # a window holding positions [idx-k+1, idx] is invalid: it
            # must start after the first gap of the run
            start = idx - k + 2
        if idx + 1 - start > best_j - best_i:
            best_i, best_j = start, idx + 1
    return best_i, best_j


def trim_gap(row, k=10):
    """A TM-align record (a mapping with ``chain1``, ``chain2`` and
    ``alignment``, e.g. a ``TMAlignDataset`` row) cut to its longest span
    without ``k`` consecutive gaps; a copy of the record when it has no
    such run."""
    aln = row["alignment"]
    is_match = np.array(list(aln)) == ":"
    if "0" * k not in "".join(map(str, is_match.astype(int))):
        return dict(row)
    i, j = trim_gap_span(is_match, k)
    states = np.array([tmstate_f(s) for s in aln])
    ax, ay = states2alignment(states, row["chain1"], row["chain2"])
    out = dict(row)
    out["chain1"] = ax[i:j].replace("-", "")
    out["chain2"] = ay[i:j].replace("-", "")
    out["alignment"] = aln[i:j]
    return out


def pad_sequences(seqs, pad_value=0, dtype=None):
    """Stack variable-length 1-D arrays into a padded matrix + lengths."""
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    L = int(lengths.max()) if len(seqs) else 0
    dtype = dtype or np.asarray(seqs[0]).dtype
    out = np.full((len(seqs), L), pad_value, dtype=dtype)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return out, lengths


def decode_tokens(codes, vocab):
    """Token ids -> string, given a token -> id ``vocab`` (sentencepiece's
    word marker ``▁`` dropped)."""
    inv = {v: k for k, v in vocab.items()}
    return "".join(inv[int(c)] for c in codes).replace("▁", "")
