"""``deepblast-tensorboard2csv``: the scalars of a training run's logdir as
a CSV (``deepblast_tpu/cli/tensorboard2csv.py``).

    python -m deepblast_torch.cli.tensorboard2csv --logdir out/logdir_... \\
        --output-csv metrics.csv [--pattern loss]

Reads the logdir's ``metrics.jsonl`` (``utils.logging.tensorboard_to_csv``);
a logdir of TensorBoard event files alone raises (ROADMAP.md queue A
item 7).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser("deepblast-tensorboard2csv")
    parser.add_argument("--logdir", type=str, required=True)
    parser.add_argument("--output-csv", type=str, required=True)
    parser.add_argument("--pattern", type=str, default=None)
    args = parser.parse_args(argv)

    from deepblast_torch.utils.logging import tensorboard_to_csv

    rows = tensorboard_to_csv(args.logdir, args.output_csv, args.pattern)
    print(f"wrote {args.output_csv} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
