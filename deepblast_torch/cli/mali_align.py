"""``deepblast-mali-align``: align the structure pairs of a Malidup/Malisam
CSV with a saved model (``deepblast_tpu/cli/mali_align.py``).

    python -m deepblast_torch.cli.mali_align --mali-pairs pairs.csv \\
        --input-mali-dir pdbs/ --load-from-checkpoint model_dir \\
        --output-alignments out.csv

The CSV's first column is its index; on each row the first two other
columns name two PDB files under ``--input-mali-dir`` (read by position:
the JAX CLI's ``res.iloc[i][0]`` meant that, and raises ``KeyError: 0``
under pandas 3, ROADMAP.md C).  Each pair's first chains (``readPDB``)
are aligned as ``align(s1.seq, s0.seq)``, the JAX order.  The output is
the input with a ``deepblast`` column of state strings and the columns
``0``, ``1``, ``2`` renamed ``query_seq``, ``hit_seq``, ``manual``,
written as pandas writes it.  It runs on ``--device`` (CUDA by default).
"""

from __future__ import annotations

import argparse

#: the JAX CLI's renames of the pairs CSV's columns
RENAME = {"0": "query_seq", "1": "hit_seq", "2": "manual"}


def main(argv=None):
    parser = argparse.ArgumentParser("deepblast-mali-align")
    parser.add_argument("--mali-pairs", type=str, required=True,
                        help="CSV with pdb filename pairs (and optionally "
                             "the manual alignment)")
    parser.add_argument("--input-mali-dir", type=str, required=True)
    parser.add_argument("--load-from-checkpoint", type=str, required=True)
    parser.add_argument("--output-alignments", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, or cpu)")
    args = parser.parse_args(argv)

    from deepblast_torch.data.parse_pdb import readPDB
    from deepblast_torch.train.checkpoint import load_model
    from deepblast_torch.utils.table import read_csv, write_csv

    model = load_model(args.load_from_checkpoint, device=args.device)
    label, index, rows = read_csv(args.mali_pairs)
    for row in rows:
        pdb0, pdb1 = list(row.values())[:2]
        _, s0 = readPDB(f"{args.input_mali_dir}/{pdb0}")
        _, s1 = readPDB(f"{args.input_mali_dir}/{pdb1}")
        row["deepblast"] = model.align(s1.seq, s0.seq)
    rows = [{RENAME.get(k, k): v for k, v in r.items()} for r in rows]
    write_csv(args.output_alignments, rows, index=index, index_label=label)
    print(f"wrote {args.output_alignments} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
