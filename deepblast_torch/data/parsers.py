"""Corpus parsers (own copy of ``deepblast_tpu/data/parsers.py``): TM-align
output, Malidup/Malisam ``.ali`` files, BLAST XML, HMMER3 text and FATCAT
ids.  Where the JAX package returns a ``pandas.DataFrame`` these return a
list of dict rows with its columns as keys, in its column order (integer
keys 0, 1, 2 where its columns are unnamed); ``utils.table.write_csv``
writes them as pandas does.  No Biopython: BLAST XML is read with
``xml.etree``, HMMER3 text directly.
"""

from __future__ import annotations

import os
import re
import subprocess

import numpy as np

from deepblast_torch.data.state_utils import revstate_f, state_f
from deepblast_torch.utils.table import fill, write_csv

__all__ = [
    "aln_f",
    "parse_block_2017",
    "parse_block_2021",
    "validate_block_2021",
    "parse_tm_align_file",
    "tm_align_batch",
    "read_mali",
    "read_mali_mammoth",
    "get_mali_structure_stats",
    "parse_blast_xml",
    "get_blast_alignments",
    "parse_hmmer_text",
    "get_hmmer_alignments",
    "parse_fatcat_ids",
]

TM_HEADER = ["chain1_name", "chain2_name", "tmscore1", "tmscore2", "rmsd",
             "chain1", "chain2", "alignment"]


# ---------------------------------------------------------------------------
# TM-align raw output
# ---------------------------------------------------------------------------

def aln_f(X):
    """Per-column TM-align state char: gap-in-2 -> '1', gap-in-1 -> '2',
    else the TM annotation (':' close pair, '.' other aligned)
    (reference: deepblast/dataset/parse_tm_align.py:30-36)."""
    a, ann, b = X
    if b == "-":
        return "1"
    if a == "-":
        return "2"
    return ann


def parse_block_2017(lines):
    """Parse one 25-line block of TM-align 20170708 output
    (reference: deepblast/dataset/parse_tm_align.py:41-86)."""
    chain1_name = lines[11].split(":")[1].strip()
    chain2_name = lines[12].split(":")[1].strip()
    tmscore1 = float(lines[17].lstrip().split(" ")[1])
    tmscore2 = float(lines[18].lstrip().split(" ")[1])
    chain1 = lines[22].strip()
    aln = lines[23]
    chain2 = lines[24].strip()
    rmsd = float(re.split(r"\s+", lines[16].lstrip().split(", ")[1])[1])
    alignment = "".join(aln_f(z) for z in zip(chain1, aln, chain2))
    return (chain1_name, chain2_name, tmscore1, tmscore2, rmsd,
            chain1.replace("-", ""), chain2.replace("-", ""), alignment)


def validate_block_2021(lines):
    """(reference: deepblast/dataset/parse_tm_align.py:116-127)"""
    try:
        return ("Chain_1" in lines[7] and "Chain_2" in lines[8]
                and "TM-score" in lines[13] and "TM-score" in lines[14]
                and ":" in lines[19] and "RMSD" in lines[12]
                and " " not in lines[18].strip()
                and " " not in lines[20].strip())
    except IndexError:
        return False


def parse_block_2021(lines):
    """Parse one 23-line block of TM-align 20210224 output
    (reference: deepblast/dataset/parse_tm_align.py:129-174)."""
    chain1_name = lines[7].split(":")[1].strip().split(" ")[0]
    chain2_name = lines[8].split(":")[1].strip().split(" ")[0]
    tmscore1 = float(lines[13].lstrip().split(" ")[1])
    tmscore2 = float(lines[14].lstrip().split(" ")[1])
    chain1 = lines[18].strip()
    aln = lines[19]
    chain2 = lines[20].strip()
    rmsd = float(re.split(r"\s+", lines[12].lstrip().split(", ")[1])[1])
    alignment = "".join(aln_f(z) for z in zip(chain1, aln, chain2))
    return (chain1_name, chain2_name, tmscore1, tmscore2, rmsd,
            chain1.replace("-", ""), chain2.replace("-", ""), alignment)


def parse_tm_align_file(fname, output=None, lines_per_block=23):
    """The rows (``TM_HEADER`` keys) of a concatenated TM-align output
    file; with ``output``, also written as the 8-column TSV (no header, no
    index)."""
    rows = []
    block = []
    i = 0
    for line in open(fname):
        if i % lines_per_block == 0 and i > 0:
            if validate_block_2021(block):
                rows.append(parse_block_2021(block))
                block = []
            else:
                i -= 1
                block = block[1:]
        block.append(line)
        i += 1
    if validate_block_2021(block):
        rows.append(parse_block_2021(block))
    rows = [dict(zip(TM_HEADER, r)) for r in rows]
    if output:
        write_csv(output, rows, sep="\t", header=False, index=False)
    return rows


def tm_align_batch(pair_file, output, pdb_root, num_jobs=4,
                   tmalign_bin="TMalign", scratch="/tmp"):
    """Fan out TMalign subprocesses over PDB id pairs
    (reference: deepblast/dataset/tm_align.py:1-38)."""
    procs = []
    for line in open(pair_file):
        xid, yid = line.rstrip().split(" ")
        xid, yid = xid.lower(), yid.lower()
        cmds = []
        paths = []
        for pid in (xid, yid):
            div = pid[1:-1]
            src = f"{pdb_root}/{div}/pdb{pid}.ent.gz"
            dst = f"{scratch}/pdb{pid}.ent.gz"
            cmds += [f"cp {src} {dst}", f"gunzip -f {dst}"]
            paths.append(f"{scratch}/pdb{pid}.ent")
        cmds.append(f"{tmalign_bin} {paths[0]} {paths[1]} >> {output}")
        cmds.append(f"rm -f {paths[0]} {paths[1]}")
        procs.append(subprocess.Popen("; ".join(cmds), shell=True))
        if len(procs) >= num_jobs:
            for p in procs:
                p.wait()
            procs = []
    for p in procs:
        p.wait()


# ---------------------------------------------------------------------------
# Malidup / Malisam
# ---------------------------------------------------------------------------

def _gapped_pair_row(X, Y):
    S = "".join(revstate_f(state_f(z)) for z in zip(X, Y))
    return {0: X.replace("-", ""), 1: Y.replace("-", ""), 2: S}


def _with_ids(rows):
    n = len(rows)
    for i, r in enumerate(rows):
        r["query_id"] = str(i)
        r["hit_id"] = str(i + n)


def read_mali(root, tool="manual", report_ids=False):
    """Rows ``{0: x, 1: y, 2: states}`` of the gapped-pair ``.ali`` files
    of ``tool`` under ``root`` (not ``manual2``); with ``report_ids`` also
    ``query_id`` (``"0"``..), ``hit_id`` (``"n"``..), ``pdb``, ``dir`` and
    ``pdb_0``, ``pdb_1``, ... (the directory's single-structure PDB files,
    None past a directory's last)."""
    import glob as _glob
    rows, single_pdbs = [], []
    for path, _, files in os.walk(root):
        for f in sorted(files):
            if ".ali" in f and tool in f and "manual2" not in f:
                lines = open(os.path.join(path, f)).readlines()
                row = _gapped_pair_row(lines[0].rstrip().upper(),
                                       lines[1].rstrip().upper())
                single_pdbs.append(sorted(
                    os.path.basename(p)
                    for p in _glob.glob(f"{path}/*.pdb")
                    if all(t not in os.path.basename(p)
                           for t in ("fast", "tm", "manual", "dali"))))
                row["pdb"] = os.path.basename(f).split(f".{tool}.ali")[0]
                row["dir"] = os.path.basename(path)
                rows.append(row)
    if not report_ids:
        return [{k: r[k] for k in (0, 1, 2)} for r in rows]
    _with_ids(rows)
    return fill([dict({k: r[k] for k in (0, 1, 2, "query_id", "hit_id",
                                         "pdb", "dir")},
                      **{f"pdb_{i}": p for i, p in enumerate(ps)})
                 for r, ps in zip(rows, single_pdbs)])


def read_mali_mammoth(root, report_ids=False):
    """Rows ``{0: x, 1: y, 2: states}`` of Mammoth's ``.ali`` files under
    ``root``; with ``report_ids`` also ``query_id``, ``hit_id`` and
    ``pdb``."""

    def strip(xx):
        return "".join(xx.split(" ")[1:]).rstrip()

    rows = []
    for path, _, files in os.walk(root):
        for f in sorted(files):
            if ".ali" in f:
                contents = open(os.path.join(path, f)).readlines()
                pred = [ln for ln in contents if "Prediction " in ln]
                expr = [ln for ln in contents if "Experiment " in ln]
                idx = np.arange(len(pred)) % 2 == 0
                X = "".join(strip(p) for p in np.array(pred)[idx])
                Y = "".join(strip(e) for e in np.array(expr)[~idx])
                X = X.replace(".", "-").rstrip().upper()
                Y = Y.replace(".", "-").rstrip().upper()
                row = _gapped_pair_row(X, Y)
                row["pdb"] = os.path.basename(f).split(".mammoth.ali")[0]
                rows.append(row)
    if not report_ids:
        return [{k: r[k] for k in (0, 1, 2)} for r in rows]
    _with_ids(rows)
    return [{k: r[k] for k in (0, 1, 2, "query_id", "hit_id", "pdb")}
            for r in rows]


def get_mali_structure_stats(root, tool="manual"):
    """One row per PDB file under ``root`` whose name contains ``tool``:
    ``x<class>`` residue counts of the DSSP classes ('-' = coil; None
    for a class another file has and this one lacks), ``pdb``, ``path``
    and ``xlen``; the assignment is :mod:`deepblast_torch.data.dssp`'s (no
    ``mkdssp``)."""
    from deepblast_torch.data.dssp import secondary_structure_counts

    rows = []
    for path, _, files in os.walk(root):
        for f in sorted(files):
            if ".pdb" in f and tool in f:
                fname = os.path.join(path, f)
                counts, length = secondary_structure_counts(fname)
                stats = {f"x{k}": v for k, v in sorted(counts.items())}
                stats["pdb"] = os.path.basename(f).split(".")[0]
                stats["path"] = fname
                stats["xlen"] = length
                rows.append(stats)
    return fill(rows)


# ---------------------------------------------------------------------------
# BLAST XML (xml.etree instead of Bio.SearchIO)
# ---------------------------------------------------------------------------

BLAST_COLUMNS = ["query_id", "hit_id", "fragment_num",
                 "query_start", "query_end", "hit_start", "hit_end",
                 "query_string", "hit_string", "alignment_string",
                 "score", "evalue"]


def parse_blast_xml(blast_path):
    """One row (``BLAST_COLUMNS``, strings) per HSP of a BLAST XML file,
    self hits left out; starts 0-based."""
    import xml.etree.ElementTree as ET
    rows = []
    root = ET.parse(blast_path).getroot()
    for it in root.iter("Iteration"):
        qid = it.findtext("Iteration_query-def") or \
            it.findtext("Iteration_query-ID")
        qid = (qid or "").split()[0]
        for hit in it.iter("Hit"):
            hid = (hit.findtext("Hit_def")
                   or hit.findtext("Hit_id") or "").split()[0]
            if qid == hid:
                continue
            for i, hsp in enumerate(hit.iter("Hsp")):
                rows.append(dict(zip(BLAST_COLUMNS, [
                    qid, hid, str(i),
                    str(int(hsp.findtext("Hsp_query-from")) - 1),
                    hsp.findtext("Hsp_query-to"),
                    str(int(hsp.findtext("Hsp_hit-from")) - 1),
                    hsp.findtext("Hsp_hit-to"),
                    hsp.findtext("Hsp_qseq"),
                    hsp.findtext("Hsp_hseq"),
                    hsp.findtext("Hsp_midline"),
                    hsp.findtext("Hsp_bit-score"),
                    hsp.findtext("Hsp_evalue"),
                ])))
    return rows


def _top_hits(rows):
    """``(query_id, hit_id) -> row`` of each pair's first row of least
    e-value (its ``evalue`` a float), in key order."""
    best = {}
    for r in rows:
        r = dict(r, evalue=float(r["evalue"]))
        key = (r["query_id"], r["hit_id"])
        if key not in best or r["evalue"] < best[key]["evalue"]:
            best[key] = r
    return dict(sorted(best.items()))


def _manual_alignments(rows, mali_root, seq_key):
    """The top hits of ``rows`` whose ids are a manual Malidup/Malisam
    pair under ``mali_root``, in key order, each with its state string
    ``aln`` (of ``seq_key``'s gapped query and hit)."""
    top = _top_hits(rows)
    manual = read_mali(mali_root, tool="manual", report_ids=True)
    keep = {(r["query_id"], r["hit_id"]) for r in manual} & set(top)
    out = []
    for key in sorted(keep):
        r = top[key]
        q, h = seq_key(r["query_string"]), seq_key(r["hit_string"])
        r["aln"] = "".join(revstate_f(state_f(z)) for z in zip(q, h))
        out.append(r)
    return out


def get_blast_alignments(blast_path, mali_root):
    """The BLAST top hits of the manual Malidup/Malisam pairs, with their
    state strings ``aln``."""
    return _manual_alignments(parse_blast_xml(blast_path), mali_root,
                              lambda s: s)


# ---------------------------------------------------------------------------
# HMMER3 text
# ---------------------------------------------------------------------------

HMMER_COLUMNS = ["query_id", "hit_id", "fragment_num",
                 "query_start", "query_end", "hit_start", "hit_end",
                 "query_string", "hit_string", "score", "evalue"]


def parse_hmmer_text(hmmer_path):
    """One row (``HMMER_COLUMNS``, strings) per domain alignment of a
    HMMER3 text output, self hits left out."""
    rows = []
    query_id = None
    hit_id = None
    dom_scores = {}
    with open(hmmer_path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith("Query:"):
            query_id = line.split()[1]
        elif line.startswith(">>"):
            hit_id = line.split()[1]
            dom_scores = {}
            # domain table follows after a header + separator
            j = i + 3
            while j < len(lines) and lines[j].strip():
                toks = lines[j].split()
                if len(toks) >= 13 and toks[1] in ("!", "?"):
                    dom_scores[int(toks[0])] = (float(toks[2]),
                                                float(toks[5]))
                j += 1
        elif line.strip().startswith("== domain"):
            dom_num = int(line.split()[2])
            qseq = hseq = None
            qs = qe = hs = he = None
            j = i + 1
            while j < len(lines):
                ln = lines[j].rstrip("\n")
                toks = ln.split()
                if not toks:
                    if qseq is not None and hseq is not None:
                        break
                elif query_id and toks[0] == query_id and len(toks) >= 4:
                    if qseq is None:
                        qs = int(toks[1]) - 1
                    qseq = (qseq or "") + toks[2]
                    qe = int(toks[3])
                elif hit_id and toks[0] == hit_id and len(toks) >= 4:
                    if hseq is None:
                        hs = int(toks[1]) - 1
                    hseq = (hseq or "") + toks[2]
                    he = int(toks[3])
                j += 1
            if qseq and hseq and query_id != hit_id:
                score, evalue = dom_scores.get(dom_num, (0.0, 0.0))
                rows.append(dict(zip(HMMER_COLUMNS, [
                    query_id, hit_id, str(dom_num - 1),
                    str(qs), str(qe), str(hs), str(he),
                    qseq.upper(), hseq.upper(),
                    str(score), str(evalue)])))
            i = j
        i += 1
    return rows


def get_hmmer_alignments(hmmer_path, mali_root):
    """The HMMER top hits of the manual Malidup/Malisam pairs, with their
    state strings ``aln`` (HMMER's ``.`` gaps read as ``-``)."""
    return _manual_alignments(parse_hmmer_text(hmmer_path), mali_root,
                              lambda s: s.replace(".", "-"))


# ---------------------------------------------------------------------------
# FATCAT id lists
# ---------------------------------------------------------------------------

def parse_fatcat_ids(lines):
    """Rows ``pdb1, chain1, pdb2, chain2`` of FATCAT rigid output ids."""

    def extract(xx):
        yy = xx[1:] if xx[0] == "d" else xx.split(":")[1]
        return yy[:4], yy[4], yy[5:]

    rows = []
    for line in lines:
        toks = re.split(r"\s+", line.strip())
        p1, c1, _ = extract(toks[0])
        p2, c2, _ = extract(toks[1])
        rows.append(dict(pdb1=p1, chain1=c1, pdb2=p2, chain2=c2))
    return rows
