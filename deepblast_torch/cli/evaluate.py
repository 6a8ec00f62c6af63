"""``deepblast-evaluate``: per-pair accuracy statistics of a saved model on
a TM-align test set (``deepblast_tpu/cli/evaluate.py``).

    python -m deepblast_torch.cli.evaluate --load-from-checkpoint model_dir \\
        --test-pairs test.tsv -o results/

``load_model`` -> ``DeepBLAST.test`` on the pairs with their names (the
validation forward: potentials -> expected alignment -> traceback) ->
``<output directory>/<test file name>-results.csv``, with pandas' index
column and the columns ``test_tp`` ... ``test_fdr``, ``query_name``,
``key_name``, one row a pair in batch order.  It runs on ``--device``
(CUDA by default).
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser("deepblast-evaluate")
    parser.add_argument("--load-from-checkpoint", type=str, required=True,
                        help="model output directory (with config.json)")
    parser.add_argument("--test-pairs", type=str, required=True)
    parser.add_argument("-o", "--output-directory", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, or cpu)")
    args = parser.parse_args(argv)

    from deepblast_torch.train.checkpoint import load_model
    from deepblast_torch.utils.table import write_csv

    model = load_model(args.load_from_checkpoint, device=args.device)
    ds = model._dataset(args.test_pairs, return_names=True)
    rows = model.test(ds)
    os.makedirs(args.output_directory, exist_ok=True)
    fname = os.path.basename(args.test_pairs)
    out = os.path.join(args.output_directory, f"{fname}-results.csv")
    write_csv(out, rows)
    print(f"wrote {out} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
