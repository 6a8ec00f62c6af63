"""``deepblast-hmm-simulate``: TM-align rows sampled from a profile HMM
(``deepblast_tpu/cli/hmm_simulate.py``).

    python -m deepblast_torch.cli.hmm_simulate --hmmfile zf-C2H2.hmm \\
        --n-sequences 100 --n-alignments 100 --output-file sim.tsv

``sim.hmm_alignments`` (HMMER's ``hmmemit``, which must be on the PATH;
the GPU machine has none, so this runs on the CPU) -> a TSV with no
header and no index, the 8 columns ``TMAlignDataset`` reads.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser("deepblast-hmm-simulate")
    parser.add_argument("--hmmfile", type=str, required=True)
    parser.add_argument("--n-sequences", type=int, default=100)
    parser.add_argument("--n-alignments", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output-file", type=str, required=True)
    args = parser.parse_args(argv)

    from deepblast_torch.sim import hmm_alignments
    from deepblast_torch.utils.table import write_csv

    rows = hmm_alignments(args.n_sequences, args.seed, args.n_alignments,
                          args.hmmfile)
    write_csv(args.output_file, rows, sep="\t", header=False, index=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
