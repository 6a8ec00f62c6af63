"""The one traffic generator.  A mix is a JSON file ``traffic/<mix>.json``
of parameters (read by ``manifest.mix``); this module turns it and a
seed into the inputs of a run.
Every seed gives the same set of sizes (lengths from a fixed grid of
quantiles, paired by a fixed permutation), in another order and with
other residues, so two seeds do the same amount of work.

Two kinds of input:

* ``pairs`` — TM-align-like rows ``(name_a, name_b, tm1, tm2, rmsd, x, y,
  states)``: ``x`` and ``y`` of lengths from the mix's ``lengths``
  distribution, paired by a permutation that no seed changes; residues
  drawn uniformly, each chain on its own; a structural alignment of
  ``round(aligned * min(n, m))`` aligned columns, their first and last at
  the chains' ends (so no boundary gap needs clipping), the rest at
  random, a ``close`` share of them ``:`` (under 5 A in TM-align's output)
  and the others ``.``; between two aligned columns the residues of ``x``
  alone (``1``) and then those of ``y`` alone (``2``);
* ``potentials`` — a batch of DP inputs on the device: ``theta =
  softplus(z)``, ``A = logsigmoid(z')`` with standard normal ``z, z'``, a
  true path per pair (a random lattice path from ``(0, 0)`` to ``(n-1,
  m-1)`` with a share of indel moves), the path as a 0/1 matrix and its
  gap mask (the cells entered by a diagonal move, and ``(0, 0)``).
"""

from __future__ import annotations

import math
import statistics
import zlib

import numpy as np
import torch

__all__ = ["RESIDUES", "rng", "torch_generator", "grid_lengths",
           "pair_lengths", "pair_rows", "potentials"]

RESIDUES = "ACDEFGHIKLMNPQRSTVWY"


def rng(seed, tag):
    """A NumPy generator for one purpose (``tag``) of a run's seed."""
    return np.random.default_rng([zlib.crc32(tag.encode()), int(seed) % 2**63])


def torch_generator(seed, tag, device):
    """A ``torch.Generator`` on ``device`` for one purpose of a seed."""
    g = torch.Generator(device=device)
    g.manual_seed((zlib.crc32(tag.encode()) << 32 ^ int(seed)) % 2**63)
    return g


def grid_lengths(spec, count):
    """``count`` lengths at the mid-quantiles of a log-normal of median
    ``spec["median"]`` and shape ``spec["sigma"]`` truncated to
    ``[spec["min"], spec["max"]]``, ascending."""
    nd = statistics.NormalDist()
    z0, z1 = (math.log(spec[k] / spec["median"]) / spec["sigma"]
              for k in ("min", "max"))
    p0, p1 = nd.cdf(z0), nd.cdf(z1)
    out = []
    for k in range(count):
        z = nd.inv_cdf(p0 + (p1 - p0) * (k + 0.5) / count)
        n = round(spec["median"] * math.exp(spec["sigma"] * z))
        out.append(int(min(max(n, spec["min"]), spec["max"])))
    return out


def pair_lengths(p):
    """The ``(n, m)`` of the mix's ``pairs``, the same for every seed: the
    grid's lengths for ``x`` and the grid under a fixed permutation for
    ``y``."""
    grid = grid_lengths(p["lengths"], p["count"])
    perm = rng(0, "pairing").permutation(len(grid))
    return [(grid[k], grid[perm[k]]) for k in range(len(grid))]


def _states(r, n, m, p):
    """A state string of ``n`` residues of ``x`` and ``m`` of ``y``:
    ``round(aligned * min(n, m))`` aligned columns (at least the two
    ends), ``round(close * count)`` of them ``:`` (the first and the last
    among them), the others ``.``.  The counts depend on ``n`` and ``m``
    alone, the places on the seed."""
    a = max(2, round(p["aligned"] * min(n, m)))
    xi = [0, *sorted(r.choice(np.arange(1, n - 1), a - 2, replace=False)
                     .tolist()), n - 1]
    yj = [0, *sorted(r.choice(np.arange(1, m - 1), a - 2, replace=False)
                     .tolist()), m - 1]
    close = max(2, round(p["close"] * a))
    near = set([0, a - 1]) | set(
        (1 + r.choice(a - 2, close - 2, replace=False)).tolist())
    out = []
    for k in range(a):
        if k:
            out.append("1" * (xi[k] - xi[k - 1] - 1)
                       + "2" * (yj[k] - yj[k - 1] - 1))
        out.append(":" if k in near else ".")
    return "".join(out)


def pair_rows(mix, seed):
    """The mix's ``pairs`` rows for ``seed``, in the seed's order."""
    p = mix["pairs"]
    r = rng(seed, "pairs")
    rows = []
    for k, (n, m) in enumerate(pair_lengths(p)):
        x = "".join(RESIDUES[i] for i in r.integers(20, size=n))
        y = "".join(RESIDUES[i] for i in r.integers(20, size=m))
        states = _states(r, n, m, p)
        tm = f"{r.uniform(0.5, 0.9):.4f}"
        rows.append((f"p{k}_a", f"p{k}_b", tm, tm, "1.0", x, y, states))
    return [rows[i] for i in r.permutation(len(rows))]


def _path(r, n, m, indel):
    """Moves of a random lattice path from ``(0, 0)`` to ``(n-1, m-1)``:
    0 a step in i alone, 1 diagonal, 2 a step in j alone."""
    extra = int(r.binomial(min(n, m) - 1, indel))
    d = min(n, m) - 1 - extra
    moves = np.array([0] * (n - 1 - d) + [1] * d + [2] * (m - 1 - d))
    return moves[r.permutation(len(moves))]


def potentials(mix, seed, device):
    """The mix's ``potentials`` batch for ``seed``: a dict of ``theta``,
    ``A`` (float32 ``(B, N, M)``), ``aln`` (float32 0/1), ``gmask``
    (bool), ``x_len``, ``y_len`` (int32 ``(B,)``), on ``device``."""
    p = mix["potentials"]
    B, N, M = p["batch"], p["n"], p["m"]
    g = torch_generator(seed, "potentials", device)
    z = torch.randn((2, B, N, M), generator=g, device=device)
    theta = torch.nn.functional.softplus(z[0])
    A = torch.nn.functional.logsigmoid(z[1])
    del z
    r = rng(seed, "paths")
    b_idx, i_idx, j_idx, diag = [], [], [], []
    for b in range(B):
        moves = _path(r, N, M, p["indel"])
        i = np.concatenate([[0], np.cumsum(moves < 2)])
        j = np.concatenate([[0], np.cumsum(moves > 0)])
        b_idx.append(np.full(len(i), b))
        i_idx.append(i)
        j_idx.append(j)
        diag.append(np.concatenate([[True], moves == 1]))
    idx = tuple(torch.as_tensor(np.concatenate(v), device=device)
                for v in (b_idx, i_idx, j_idx))
    aln = torch.zeros((B, N, M), device=device)
    aln[idx] = 1.0
    gmask = torch.zeros((B, N, M), dtype=torch.bool, device=device)
    keep = torch.as_tensor(np.concatenate(diag), device=device)
    gmask[tuple(t[keep] for t in idx)] = True
    lengths = torch.tensor([N] * B, dtype=torch.int32, device=device), \
        torch.tensor([M] * B, dtype=torch.int32, device=device)
    return dict(theta=theta, A=A, aln=aln, gmask=gmask, x_len=lengths[0],
                y_len=lengths[1])
