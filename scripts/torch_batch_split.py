#!/usr/bin/env python3
"""How a data parallel shard's rounding reaches the loss, in one process on
one NVIDIA GPU: a training batch of 8 rows of ``chip_smoke.py``'s phase
``parallel`` (seeded TM-align rows of 100-300 residues) against its two
halves of 4, through the LM (ProtT5-XL width with seeded random weights)
and the CNN-1024 heads: the largest difference of the LM features, of the
match potentials and of the loss (the halves' mean), over their scale, at
24 and at 2 blocks.

    python3 scripts/torch_batch_split.py

A shard and the whole batch multiply matrices of other shapes, which
cuBLAS rounds differently; this says how far the model's depth carries
that.  Run it from the root of a checkout; it needs CUDA.
"""

import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from deepblast_torch.models.lm import T5Config, T5Encoder  # noqa: E402
from deepblast_torch.train.trainer import (DeepBLAST,  # noqa: E402
                                           DeepBLASTConfig)


def of_scale(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def main():
    card = cs.card_line()
    cs.log(card)
    cs.phase_build()
    rng = np.random.default_rng(9)
    n, lo, hi = cs.PARALLEL_ROWS
    rows = [cs.homolog_row(rng, f"p{i}", lo, hi) for i in range(n)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.tsv")
        cs._write_tsv(path, rows)
        for blocks in (24, 2):
            lm = T5Encoder(dataclasses.replace(T5Config.prot_t5_xl(),
                                               num_layers=blocks),
                           device="cuda")
            model = DeepBLAST(DeepBLASTConfig(lm_type="prot_t5",
                                              batch_size=8, dropout=0.0),
                              lm=lm).init()
            batch = next(iter(model._batches(model._dataset(path), True,
                                             0)))
            out = {}
            with torch.no_grad():
                for name, rows_of in (("all", slice(0, 8)),
                                      ("lo", slice(0, 4)),
                                      ("hi", slice(4, 8))):
                    b = model._loss_batch({k: v[rows_of]
                                           for k, v in batch.items()})
                    hx, hy = model._embeddings(b)
                    aln, theta, _ = model.aligner(hx, hy, (b["x_len"],
                                                           b["y_len"]))
                    out[name] = (hx, theta, model.compute_loss(b, aln))
            halves = [torch.cat([out["lo"][i], out["hi"][i]])
                      for i in (0, 1)]
            loss, loss2 = out["all"][2].item(), \
                ((out["lo"][2] + out["hi"][2]) / 2).item()
            feats, theta = out["all"][0], out["all"][1]
            cs.log(f"{blocks} blocks: features "
                   f"{of_scale(halves[0], feats):.3g} of scale (|max| "
                   f"{feats.abs().max().item():.4g}), theta "
                   f"{of_scale(halves[1], theta):.3g} (|max| "
                   f"{theta.abs().max().item():.4g}), loss "
                   f"{abs(loss2 - loss) / loss:.3g} (B = 8 {loss!r}, "
                   f"halves' mean {loss2!r}) [{card}]")
            del model, lm, out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
