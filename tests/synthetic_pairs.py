"""Synthetic proteins, TM-align rows and structure pairs, shared by
``chip_smoke.py`` and the port's CPU tests.

:func:`homolog_row` makes a TM-align TSV row (a protein, a homolog with
substitutions and short indels, the alignment that made it);
:func:`write_structure_pair` writes the row's two chains as PDB files
carved out of one ideal backbone (:func:`segmented_fold`), as
``scripts/quality_eval.py``'s structural leg does.  The PDB
writer imports the port's ``dssp`` and ``parse_pdb`` when called.
"""

RESIDUES = "ACDEFGHIKLMNPQRSTVWY"


def protein(rng, lo, hi):
    return "".join(rng.choice(list(RESIDUES), int(rng.integers(lo, hi + 1))))


def homolog_row(rng, name, lo, hi, cap=1024):
    """A TM-align TSV row: a protein of length lo..hi, a homolog with
    substitutions and short indels (both shorter than ``cap``), and the
    alignment that made it."""
    while True:
        x = protein(rng, lo, hi)
        y, states = [], []
        for c in x:
            u = rng.random()
            if u < 0.04:
                states.append("1")              # deleted from y
                continue
            y.append(rng.choice(list(RESIDUES)) if u < 0.25 else c)
            states.append(":")
            if rng.random() < 0.03:             # inserted into y
                ins = rng.integers(1, 4)
                y.extend(rng.choice(list(RESIDUES), ins))
                states.extend("2" * ins)
        if max(len(x), len(y)) < cap:
            tm = rng.uniform(0.5, 0.9)
            return [f"{name}_a", f"{name}_b", f"{tm:.4f}", f"{tm:.4f}",
                    "1.0", x, "".join(y), "".join(states)]


def segmented_fold(rng, n):
    """(phi, psi) of ``n`` residues in runs of helix, strand and loop
    (``scripts/quality_eval.py``'s structural leg), so that a misaligned
    pair costs TM-score."""
    phi_psi = []
    while len(phi_psi) < n:
        kind, seg = rng.integers(0, 3), int(rng.integers(4, 12))
        if kind == 0:
            phi_psi += [(-57.0, -47.0)] * seg
        elif kind == 1:
            phi_psi += [(-139.0, 135.0)] * seg
        else:
            phi_psi += [(float(rng.uniform(-150, -50)),
                         float(rng.uniform(-60, 160))) for _ in range(seg)]
    return phi_psi[:n]


def write_structure_pair(rng, row, path_x, path_y):
    """The two chains of a TM-align row (:func:`homolog_row`) as PDB files,
    carved out of one ideal backbone (``dssp.build_backbone``) over the
    columns of its alignment: x takes the ``:`` and ``1`` columns, y the
    ``:`` and ``2`` ones."""
    from deepblast_torch.data.dssp import build_backbone
    from deepblast_torch.data.parse_pdb import AA_321
    aa_123 = {v: k for k, v in AA_321.items()}
    states = row[7]
    co = build_backbone(segmented_fold(rng, len(states)))
    for path, seq, keep in ((path_x, row[5], ":1"), (path_y, row[6], ":2")):
        cols = [i for i, s in enumerate(states) if s in keep]
        with open(path, "w") as f:
            serial = 1
            for r, i in enumerate(cols):
                for key, lab in (("N", " N  "), ("CA", " CA "),
                                 ("C", " C  "), ("O", " O  ")):
                    px, py, pz = co[key][i]
                    f.write(f"ATOM  {serial:5d} {lab} {aa_123[seq[r]]} A"
                            f"{r + 1:4d}    {px:8.3f}{py:8.3f}{pz:8.3f}"
                            f"  1.00  0.00\n")
                    serial += 1
            f.write("TER\nEND\n")

