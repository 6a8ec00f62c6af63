"""BLOSUM62 and simulated aligned pairs (own copy of
``deepblast_tpu/data/substitution.py``).

``BLOSUM62`` (Henikoff & Henikoff 1992, public domain) in half-bit
log-odds, its background frequencies, and :func:`simulate_blosum_pairs`,
which samples aligned protein pairs from the BLOSUM62 *joint*
distribution ``q(a, b) ∝ p(a) p(b) 2^{S(a,b)/2}`` with affine-geometric
indels, so classic NW scoring with BLOSUM62 is the Bayes-matched baseline
for the simulated corpus.  :func:`simulate_hmm_pairs` and
:func:`sample_hmm_sequences` add a hidden secondary-structure-like chain,
so neighbouring residues carry context.  The simulators return rows in
``TM_COLUMNS`` order (lists), where the JAX package returns a
``pandas.DataFrame`` of them; the same seed gives the same rows.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "AA20",
    "BLOSUM62",
    "BLOSUM62_FREQS",
    "blosum62_matrix",
    "substitution_theta",
    "simulate_blosum_pairs",
    "simulate_hmm_pairs",
    "sample_hmm_sequences",
    "hmm_state_emissions",
]

AA20 = "ARNDCQEGHILKMFPSTWYV"

# 20x20 half-bit log-odds, rows/cols in AA20 order
_B62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4
"""

BLOSUM62 = np.array([[int(v) for v in row.split()]
                     for row in _B62.strip().split("\n")], dtype=np.int32)

# Robinson & Robinson background frequencies (BLOSUM62's), AA20 order
BLOSUM62_FREQS = np.array([
    0.078, 0.051, 0.041, 0.052, 0.024, 0.034, 0.059, 0.083, 0.025, 0.062,
    0.092, 0.056, 0.024, 0.044, 0.043, 0.059, 0.055, 0.014, 0.034, 0.072])
BLOSUM62_FREQS = BLOSUM62_FREQS / BLOSUM62_FREQS.sum()


def blosum62_matrix(alphabet=AA20):
    """BLOSUM62 reindexed to an arbitrary residue alphabet (unknown
    residues get the X-like column mean)."""
    idx = {a: i for i, a in enumerate(AA20)}
    L = len(alphabet)
    out = np.zeros((L, L), np.float32)
    mean = BLOSUM62.mean()
    for i, a in enumerate(alphabet):
        for j, b in enumerate(alphabet):
            if a in idx and b in idx:
                out[i, j] = BLOSUM62[idx[a], idx[b]]
            else:
                out[i, j] = mean
    return out


def substitution_theta(x, y, matrix=None, alphabet=AA20):
    """(N, M) substitution-score potentials for two sequences — the
    classic-NW ``theta`` (baseline for quality evaluation)."""
    if matrix is None:
        matrix = blosum62_matrix(alphabet)
    idx = {a: i for i, a in enumerate(alphabet)}
    xi = np.asarray([idx.get(c, 0) for c in x])
    yi = np.asarray([idx.get(c, 0) for c in y])
    return matrix[np.ix_(xi, yi)]


def _joint():
    """BLOSUM62 target pair distribution q(a, b) from the log-odds."""
    odds = 2.0 ** (BLOSUM62 / 2.0)
    q = BLOSUM62_FREQS[:, None] * BLOSUM62_FREQS[None, :] * odds
    return q / q.sum()


def simulate_blosum_pairs(n_pairs, seed=0, min_len=30, max_len=80,
                          gap_open=0.04, gap_extend=0.35):
    """Sample ``n_pairs`` aligned pairs from the BLOSUM62 joint.

    Alignment columns follow a 3-state process: match columns draw
    ``(a, b) ~ q``; gaps open with ``gap_open`` per column and extend
    geometrically with ``gap_extend``; gap residues draw from the
    background.  Returns rows in ``TM_COLUMNS`` order, which
    ``TMAlignDataset`` takes (names, tm1, tm2, rmsd, chain1, chain2,
    states), with ':' match / '1' y-gap (x advances) / '2' x-gap (y
    advances) state strings — the ``tmstate_f`` convention."""
    rng = np.random.default_rng(seed)
    q = _joint()
    flat = q.reshape(-1)
    rows = []
    for k in range(n_pairs):
        n_cols = int(rng.integers(min_len, max_len + 1))
        x, y, states = [], [], []
        c = 0
        while c < n_cols:
            r = rng.random()
            if r < gap_open and c > 0:            # x-gap run (y advances)
                glen = int(rng.geometric(1.0 - gap_extend))
                for _ in range(min(glen, n_cols - c)):
                    y.append(AA20[rng.choice(20, p=BLOSUM62_FREQS)])
                    states.append("2")
                    c += 1
            elif r < 2 * gap_open and c > 0:      # y-gap run (x advances)
                glen = int(rng.geometric(1.0 - gap_extend))
                for _ in range(min(glen, n_cols - c)):
                    x.append(AA20[rng.choice(20, p=BLOSUM62_FREQS)])
                    states.append("1")
                    c += 1
            else:
                ab = rng.choice(400, p=flat)
                x.append(AA20[ab // 20])
                y.append(AA20[ab % 20])
                states.append(":")
                c += 1
        rows.append([f"sim{k}x", f"sim{k}y", 0.9, 0.9, 1.0,
                     "".join(x), "".join(y), "".join(states)])
    return rows


# ---------------------------------------------------------------------------
# Context-structured simulation: hidden secondary-structure-like states
# ---------------------------------------------------------------------------

# A 3-state (helix/strand/loop-like) Markov chain over alignment columns.
# Residue emissions are the BLOSUM62 background reweighted by per-state
# propensity boosts (helix-formers, strand-formers, loop-formers), so
# neighbouring residues carry mutual information — unlike the i.i.d.
# columns of :func:`simulate_blosum_pairs`, a language model CAN learn
# context here, which is what makes the pretrained-LM quality leg
# measurable (scripts/quality_bilm.py).
HMM_STATES = "HEL"
HMM_INIT = np.array([0.40, 0.25, 0.35])
HMM_TRANS = np.array([
    [0.92, 0.02, 0.06],
    [0.03, 0.88, 0.09],
    [0.10, 0.12, 0.78],
])
_STATE_BOOST = {"H": "AELMQKRH", "E": "VIYCWFT", "L": "GNPSD"}


def hmm_state_emissions(boost=4.0):
    """(3, 20) per-state residue distributions (AA20 order)."""
    out = []
    for s in HMM_STATES:
        w = BLOSUM62_FREQS.copy()
        for ch in _STATE_BOOST[s]:
            w[AA20.index(ch)] *= boost
        out.append(w / w.sum())
    return np.stack(out)


def sample_hmm_sequences(n, seed=0, min_len=30, max_len=80, boost=4.0):
    """Single sequences from the hidden-state chain (LM pretraining
    corpus — same marginal process as :func:`simulate_hmm_pairs`)."""
    rng = np.random.default_rng(seed)
    em = hmm_state_emissions(boost)
    seqs = []
    for _ in range(n):
        L = int(rng.integers(min_len, max_len + 1))
        s = rng.choice(3, p=HMM_INIT)
        chars = []
        for _ in range(L):
            chars.append(AA20[rng.choice(20, p=em[s])])
            s = rng.choice(3, p=HMM_TRANS[s])
        seqs.append("".join(chars))
    return seqs


def simulate_hmm_pairs(n_pairs, seed=0, min_len=30, max_len=80,
                       gap_open=0.04, gap_extend=0.35, boost=4.0):
    """Aligned pairs over the hidden-state chain.

    Per match column in state ``s``: ``a ~ p_s`` and ``b ~ q(b | a)``
    (the BLOSUM62 conditional), so pairs are substitution-coupled like
    :func:`simulate_blosum_pairs` but the x-side (and hence both sides)
    carries Markov context.  Gap-run residues draw from the current
    state's emission distribution.  Returns the same rows in
    ``TM_COLUMNS`` order, ':'/'1'/'2' state strings (``tmstate_f``
    convention)."""
    rng = np.random.default_rng(seed)
    em = hmm_state_emissions(boost)
    cond = _joint()
    cond = cond / cond.sum(axis=1, keepdims=True)
    rows = []
    for k in range(n_pairs):
        n_cols = int(rng.integers(min_len, max_len + 1))
        s = rng.choice(3, p=HMM_INIT)
        x, y, states = [], [], []
        c = 0
        while c < n_cols:
            r = rng.random()
            if r < gap_open and c > 0:            # x-gap run (y advances)
                glen = int(rng.geometric(1.0 - gap_extend))
                for _ in range(min(glen, n_cols - c)):
                    y.append(AA20[rng.choice(20, p=em[s])])
                    states.append("2")
                    s = rng.choice(3, p=HMM_TRANS[s])
                    c += 1
            elif r < 2 * gap_open and c > 0:      # y-gap run (x advances)
                glen = int(rng.geometric(1.0 - gap_extend))
                for _ in range(min(glen, n_cols - c)):
                    x.append(AA20[rng.choice(20, p=em[s])])
                    states.append("1")
                    s = rng.choice(3, p=HMM_TRANS[s])
                    c += 1
            else:
                a = rng.choice(20, p=em[s])
                b = rng.choice(20, p=cond[a])
                x.append(AA20[a])
                y.append(AA20[b])
                states.append(":")
                s = rng.choice(3, p=HMM_TRANS[s])
                c += 1
        rows.append([f"hmm{k}x", f"hmm{k}y", 0.9, 0.9, 1.0,
                     "".join(x), "".join(y), "".join(states)])
    return rows
