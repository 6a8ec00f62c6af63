"""C-alpha trace of a PDB file (own copy of
``deepblast_tpu/data/parse_pdb.py``).

Reads the first chain's CA trace and one-letter sequence.  Missing or
duplicate residue numbers and unknown residue types clear the returned
flag.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np

__all__ = ["readPDB", "PDBCA", "AA_321"]

PDBCA = namedtuple("PDBCA", ["seq", "CA", "first_resnum", "length"])

AA_321 = {
    "ALA": "A", "CYS": "C", "ASP": "D", "GLU": "E", "PHE": "F",
    "GLY": "G", "HIS": "H", "ILE": "I", "LYS": "K", "LEU": "L",
    "MET": "M", "ASN": "N", "PRO": "P", "GLN": "Q", "ARG": "R",
    "SER": "S", "THR": "T", "VAL": "V", "TRP": "W", "TYR": "Y",
    "XXX": "X",
}


def readPDB(filename, verbose=False):
    """Returns ``(ok, PDBCA(seq, CA, first_resnum, length))`` for the first
    chain/model of ``filename``."""
    points = []
    seq = []
    first_res_num = None
    last_res_num = None
    ok = True
    with open(filename) as f:
        for line in f:
            if line[:3] == "TER" or line[:6] == "ENDMDL":
                break
            if line[:4] == "ATOM" or line[:6] == "HETATM":
                if line[12:16] != " CA ":
                    continue
                seqnum = int(line[22:26])
                if last_res_num is None:
                    first_res_num = seqnum
                    last_res_num = seqnum - 1
                if seqnum - last_res_num != 1:
                    ok = False  # missing or duplicate residue
                last_res_num = seqnum
                resname = line[17:20]
                h = AA_321.get(resname)
                if h is None:
                    h = "Z"
                    ok = False
                seq.append(h)
                points.append([float(line[30:38]), float(line[38:46]),
                               float(line[46:54])])
    return ok, PDBCA("".join(seq), np.asarray(points, float),
                     first_res_num, len(seq))
