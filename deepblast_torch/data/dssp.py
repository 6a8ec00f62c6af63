"""Secondary-structure assignment (Kabsch-Sander / DSSP) and ideal
backbones (own copy of ``deepblast_tpu/data/dssp.py``), numpy only.

The assignment follows the published algorithm (Kabsch & Sander 1983,
Biopolymers 22:2577), vectorized over residue pairs:

* backbone amide H placed from the previous residue's C=O direction;
* H-bond between CO(i) and NH(j) when the Coulomb energy
  ``0.084 * 332 * (1/r_ON + 1/r_CH - 1/r_OH - 1/r_CN) < -0.5`` kcal/mol;
* n-turns (n = 3, 4, 5) -> G/H/I helices (two consecutive turns start a
  minimal helix), parallel/antiparallel bridges -> B (isolated) and
  E (ladders), T turns, S bends (kappa > 70 deg);
* DSSP priority order H > B > E > G > I > T > S; chain breaks (residue
  numbering gaps or C(i)..N(i+1) > 2.5 A) split all patterns.

Classes are DSSP's 8 letters with '-' for coil.  :func:`build_backbone`
places an ideal backbone from (phi, psi) dihedrals (NeRF), for tests and
synthetic structures.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "read_backbone",
    "place_amide_hydrogens",
    "hbond_matrix",
    "assign_secondary_structure",
    "secondary_structure_counts",
    "build_backbone",
]

# Kabsch-Sander H-bond constants
_Q1Q2F = 0.084 * 332.0     # partial charges x dimensional factor (kcal/mol)
_HBOND_CUTOFF = -0.5       # kcal/mol
_CA_CUTOFF = 9.0           # Angstrom prefilter on CA(i)-CA(j)
_BEND_ANGLE = 70.0         # degrees (S assignment)
_BREAK_CN = 2.5            # Angstrom: C(i)-N(i+1) beyond this = chain break

_BACKBONE_ATOMS = (" N  ", " CA ", " C  ", " O  ")


def read_backbone(filename):
    """Read the first chain/model's backbone (N, CA, C, O) from a PDB file.

    Returns ``(coords, resnames, resnums)`` where ``coords`` is a dict of
    (L, 3) arrays keyed "N"/"CA"/"C"/"O".  Residues missing any backbone
    atom are dropped (DSSP does the same).  Stops at TER/ENDMDL like
    :func:`deepblast_torch.data.parse_pdb.readPDB`."""
    rows = {}     # resnum -> {atom: xyz, "name": resname}
    order = []
    with open(filename) as f:
        for line in f:
            if line[:3] == "TER" or line[:6] == "ENDMDL":
                break
            if line[:4] != "ATOM" and line[:6] != "HETATM":
                continue
            atom = line[12:16]
            if atom not in _BACKBONE_ATOMS:
                continue
            # first altloc only
            if line[16] not in (" ", "A"):
                continue
            num = int(line[22:26])
            if num not in rows:
                rows[num] = {"name": line[17:20].strip()}
                order.append(num)
            rows[num][atom.strip()] = (
                float(line[30:38]), float(line[38:46]), float(line[46:54]))
    keep = [n for n in order
            if all(a in rows[n] for a in ("N", "CA", "C", "O"))]
    coords = {a: np.asarray([rows[n][a] for n in keep], float)
              for a in ("N", "CA", "C", "O")}
    names = [rows[n]["name"] for n in keep]
    return coords, names, np.asarray(keep, int)


def _chain_breaks(coords, resnums):
    """Boolean (L-1,) — True where residue i+1 does NOT follow i."""
    L = len(resnums)
    if L < 2:
        return np.zeros((0,), bool)
    gap = np.diff(resnums) != 1
    cn = np.linalg.norm(coords["N"][1:] - coords["C"][:-1], axis=1)
    return gap | (cn > _BREAK_CN)


def place_amide_hydrogens(coords, breaks, resnames=None):
    """Amide H of residue i: 1.0 A from N(i) along the C(i-1)->O(i-1)
    bond direction reversed (DSSP's construction).  No H for the first
    residue of each chain segment or for prolines (no amide H)."""
    N = coords["N"]
    L = N.shape[0]
    H = np.full((L, 3), np.nan)
    if L < 2:
        return H
    co = coords["C"][:-1] - coords["O"][:-1]
    co /= np.linalg.norm(co, axis=1, keepdims=True)
    H[1:] = N[1:] + co
    H[np.concatenate(([True], breaks))] = np.nan
    if resnames is not None:
        pro = np.asarray([nm == "PRO" for nm in resnames])
        H[pro] = np.nan
    return H


def hbond_matrix(coords, H):
    """(L, L) boolean: ``hb[i, j]`` = CO of residue i accepts an H-bond
    from NH of residue j (Kabsch-Sander energy < -0.5 kcal/mol).

    Pairs with |i-j| < 2, missing H (chain starts, prolines), or
    CA separation > 9 A are False."""
    C, O, Nn, CA = coords["C"], coords["O"], coords["N"], coords["CA"]
    L = C.shape[0]

    def dist(a, b):
        return np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)

    with np.errstate(invalid="ignore", divide="ignore"):
        E = _Q1Q2F * (1.0 / dist(O, Nn) + 1.0 / dist(C, H)
                      - 1.0 / dist(O, H) - 1.0 / dist(C, Nn))
    hb = E < _HBOND_CUTOFF
    hb &= ~np.isnan(E)
    idx = np.arange(L)
    near = np.abs(idx[:, None] - idx[None, :]) < 2
    hb &= ~near
    hb &= dist(CA, CA) < _CA_CUTOFF
    return hb


def _bend_mask(CA, breaks):
    """S assignment: kappa(i) = angle(CA(i)-CA(i-2), CA(i+2)-CA(i)) > 70
    deg, within one chain segment."""
    L = CA.shape[0]
    S = np.zeros(L, bool)
    if L < 5:
        return S
    u = CA[2:-2] - CA[:-4]
    v = CA[4:] - CA[2:-2]
    cosk = np.sum(u * v, axis=1) / (
        np.linalg.norm(u, axis=1) * np.linalg.norm(v, axis=1))
    kappa = np.degrees(np.arccos(np.clip(cosk, -1.0, 1.0)))
    S[2:-2] = kappa > _BEND_ANGLE
    # no bend across a break: residue i uses i-2..i+2
    for b in np.nonzero(breaks)[0]:   # break between b and b+1
        S[max(0, b - 1):b + 3] = False
    return S


def assign_secondary_structure(coords, resnames=None, resnums=None):
    """8-class DSSP string (H, G, I, E, B, T, S, '-') for one chain.

    ``coords``: dict of (L, 3) arrays "N"/"CA"/"C"/"O" (e.g. from
    :func:`read_backbone`)."""
    L = coords["CA"].shape[0]
    if L == 0:
        return ""
    if resnums is None:
        resnums = np.arange(L)
    breaks = _chain_breaks(coords, resnums)
    H = place_amide_hydrogens(coords, breaks, resnames)
    hb = hbond_matrix(coords, H)

    # mask H-bonds across chain breaks (pattern rules assume continuity
    # only through the turn span, but a bond itself may cross segments in
    # real DSSP; keeping them is harmless for counts — turns however must
    # not span breaks)
    seg = np.zeros(L, int)
    seg[1:] = np.cumsum(breaks)

    def turn(n):
        t = np.zeros(L, bool)
        if L > n:
            t[:-n] = hb[np.arange(L - n), np.arange(n, L)]
            t[:-n] &= seg[:-n] == seg[n:]
        return t

    t3, t4, t5 = turn(3), turn(4), turn(5)

    ss = np.full(L, "-", dtype="U1")

    # -- bridges / ladders (computed first; written after H below) -------
    para = np.zeros((L, L), bool)
    anti = np.zeros((L, L), bool)
    ii = np.arange(1, L - 1)
    jj = np.arange(1, L - 1)
    I, J = np.meshgrid(ii, jj, indexing="ij")
    sep = np.abs(I - J) >= 3
    para[1:-1, 1:-1] = sep & ((hb[I - 1, J] & hb[J, I + 1])
                              | (hb[J - 1, I] & hb[I, J + 1]))
    anti[1:-1, 1:-1] = sep & ((hb[I, J] & hb[J, I])
                              | (hb[I - 1, J + 1] & hb[J - 1, I + 1]))
    bridge = para | anti
    # ladder: bridges (i, j) and (i+1, j') adjacent (parallel j'=j+1,
    # antiparallel j'=j-1) extend into E; isolated bridges are B
    is_E = np.zeros(L, bool)
    is_B = np.zeros(L, bool)
    bi, bj = np.nonzero(bridge)
    bset = set(zip(bi.tolist(), bj.tolist()))
    for i, j in bset:
        ext = (((i + 1, j + 1) in bset and para[i, j])
               or ((i + 1, j - 1) in bset and anti[i, j])
               or ((i - 1, j - 1) in bset and para[i, j])
               or ((i - 1, j + 1) in bset and anti[i, j]))
        if ext:
            is_E[i] = is_E[j] = True
        else:
            is_B[i] = is_B[j] = True
    is_B &= ~is_E

    # -- minimal helices: two consecutive n-turns ------------------------
    def helix(tn, n):
        h = np.zeros(L, bool)
        starts = np.nonzero(tn[:-1] & tn[1:])[0]    # turn at i-1 and i
        for s in starts:
            h[s + 1:s + 1 + n] = True
        return h

    h4 = helix(t4, 4)
    ss[h4] = "H"
    free = ss == "-"
    ss[is_E & free] = "E"
    free = ss == "-"
    ss[is_B & free] = "B"
    h3 = helix(t3, 3)
    free = ss == "-"
    ss[h3 & free] = "G"
    h5 = helix(t5, 5)
    free = ss == "-"
    ss[h5 & free] = "I"

    # -- turns: any residue inside an n-turn span ------------------------
    is_T = np.zeros(L, bool)
    for tn, n in ((t3, 3), (t4, 4), (t5, 5)):
        for s in np.nonzero(tn)[0]:
            is_T[s + 1:s + n] = True
    free = ss == "-"
    ss[is_T & free] = "T"

    # -- bends ------------------------------------------------------------
    free = ss == "-"
    ss[_bend_mask(coords["CA"], breaks) & free] = "S"
    return "".join(ss)


def secondary_structure_counts(filename):
    """``(Counter of classes, length)`` of the first chain of a PDB file
    (``parsers.get_mali_structure_stats``' row)."""
    from collections import Counter
    coords, names, nums = read_backbone(filename)
    ss = assign_secondary_structure(coords, names, nums)
    return Counter(ss), len(ss)


# ---------------------------------------------------------------------------
# Synthetic backbone construction (tests / simulation)
# ---------------------------------------------------------------------------

# idealized backbone internal coordinates (Engh & Huber)
_B_NCA, _B_CAC, _B_CN, _B_CO = 1.458, 1.525, 1.329, 1.231
_A_NCAC, _A_CACN, _A_CNCA = 111.2, 116.2, 121.7


def _extend(a, b, c, bond, angle, dihedral):
    """NeRF: place atom d bonded to c with the given internal coords."""
    angle = np.radians(angle)
    dihedral = np.radians(dihedral)
    bc = c - b
    bc /= np.linalg.norm(bc)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n)
    m = np.cross(n, bc)
    d = np.array([-bond * np.cos(angle),
                  bond * np.sin(angle) * np.cos(dihedral),
                  bond * np.sin(angle) * np.sin(dihedral)])
    return c + d[0] * bc + d[1] * m + d[2] * n


def build_backbone(phi_psi, omega=180.0):
    """Ideal backbone (N, CA, C, O coords) for a chain with the given
    (phi, psi) dihedrals — test/simulation helper (an ideal alpha helix
    is ``[(-57, -47)] * L``).  Returns a coords dict like
    :func:`read_backbone`."""
    L = len(phi_psi)
    N = np.zeros((L, 3))
    CA = np.zeros((L, 3))
    C = np.zeros((L, 3))
    # seed residue
    N[0] = (0.0, 0.0, 0.0)
    CA[0] = (_B_NCA, 0.0, 0.0)
    ang = np.radians(180.0 - _A_NCAC)
    C[0] = CA[0] + _B_CAC * np.array([np.cos(ang), np.sin(ang), 0.0])
    for i in range(1, L):
        psi_prev = phi_psi[i - 1][1]
        N[i] = _extend(N[i - 1], CA[i - 1], C[i - 1],
                       _B_CN, _A_CACN, psi_prev)
        CA[i] = _extend(CA[i - 1], C[i - 1], N[i],
                        _B_NCA, _A_CNCA, omega)
        C[i] = _extend(C[i - 1], N[i], CA[i],
                       _B_CAC, _A_NCAC, phi_psi[i][0])
    O = np.zeros((L, 3))
    for i in range(L):
        if i + 1 < L:
            d1 = CA[i] - C[i]
            d2 = N[i + 1] - C[i]
            v = -(d1 / np.linalg.norm(d1) + d2 / np.linalg.norm(d2))
        else:
            # terminal O: anti to the CA->C direction in the last plane
            v = C[i] - CA[i]
        O[i] = C[i] + _B_CO * v / np.linalg.norm(v)
    return {"N": N, "CA": CA, "C": C, "O": O}
