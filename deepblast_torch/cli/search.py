"""Score query x database FASTA pairs with a saved model
(``deepblast_tpu/cli/search.py``).

    python -m deepblast_torch.cli.search --query-fasta q.fa --db-fasta db.fa \\
        --load-from-checkpoint model_dir --output-file hits.tsv

Batch formation is a single accumulator: pairs flush in input order every
``--batch-size``, padded to the batch maximum rounded up to
``--pad-multiple``.  Each output line is ``qid  dbid  score  score/(n*m)``
with the scores rounded to 4 decimals, as the JAX package writes them.
Scoring runs on one device (``--device``, CUDA by default), with the DP
backend of the checkpoint's ``config.json``; data parallel search is a
later slice.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser("deepblast-search")
    parser.add_argument("--query-fasta", type=str, required=True)
    parser.add_argument("--db-fasta", type=str, required=True)
    parser.add_argument("--load-from-checkpoint", type=str, required=True,
                        help="model directory written by "
                             "deepblast_torch.train.checkpoint.save_model")
    parser.add_argument("--output-file", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=10)
    parser.add_argument("--pad-multiple", type=int, default=64,
                        help="round padded sequence lengths up to this "
                             "multiple")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from deepblast_torch.data.dataset import FastaDataset
    from deepblast_torch.data.state_utils import pad_sequences
    from deepblast_torch.train.checkpoint import load_model

    model = load_model(args.load_from_checkpoint, device=args.device)
    ds = FastaDataset(args.query_fasta, args.db_fasta,
                      tokenizer=model.tokenizer)
    pm = max(1, args.pad_multiple)

    def padded(seqs):
        toks, lens = pad_sequences(seqs)
        L = -(-toks.shape[1] // pm) * pm
        return np.pad(toks, ((0, 0), (0, L - toks.shape[1]))), lens

    def flush(items, out):
        xs, xl = padded([it["x"] for it in items])
        ys, yl = padded([it["y"] for it in items])
        scores = model.score_pairs(dict(x=xs, y=ys, x_len=xl, y_len=yl))
        for it, s, ql, dl in zip(items, scores.cpu().numpy(), xl, yl):
            norm = s / (float(ql) * float(dl))
            out.write(f"{it['qid']}\t{it['dbid']}\t"
                      f"{np.round(s, 4)}\t{np.round(norm, 4)}\n")

    with open(args.output_file, "w") as out:
        buf = []
        for item in ds:
            buf.append(item)
            if len(buf) >= args.batch_size:
                flush(buf, out)
                buf = []
        if buf:
            flush(buf, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
