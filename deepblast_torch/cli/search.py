"""Score query x database FASTA pairs with a saved model
(``deepblast_tpu/cli/search.py``).

    python -m deepblast_torch.cli.search --query-fasta q.fa --db-fasta db.fa \\
        --load-from-checkpoint model_dir --output-file hits.tsv

Batch formation is a single accumulator: pairs flush in input order every
``--batch-size``, padded to the batch maximum rounded up to
``--pad-multiple``.  Each output line is ``qid  dbid  score  score/(n*m)``
with the scores rounded to 4 decimals, as the JAX package writes them.
Scoring runs on ``--device`` (CUDA by default) with the DP backend of the
checkpoint's ``config.json``.

Data parallel (``--mesh auto``, the default, under a process group of
more than one rank: torchrun's, or one the caller started): every launch
is padded to ``full`` rows, ``--batch-size`` rounded up to a multiple of
the ranks, by repeating its last item (``cli/search.py:98-114``; without
a process group, or with ``--mesh none``, ``full`` is ``--batch-size``);
each rank scores its rows, every rank receives all the scores, and rank 0
writes the lines in input order.  ``--mesh none`` scores everything on
rank 0 and the other ranks return at once: the group's rank 0, or under
torchrun without a group (``--mesh none`` joins none) the process whose
``RANK`` is 0.  Two launches are in flight (``dispatch`` / ``drain``): a
launch copies its padded batch to the device, scores it and starts the
copy of its scores into pinned host memory behind an event; its lines are
written once the launch after the next has been issued, so the host
tokenizes and pads while the card scores.  The file is the one a
synchronous loop over the same launches writes.
"""

from __future__ import annotations

import argparse
import os
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from deepblast_torch.parallel import mesh as mesh_lib

#: launches in flight before the oldest one's lines are written
INFLIGHT = 2


def main(argv=None):
    parser = argparse.ArgumentParser("deepblast-search")
    parser.add_argument("--query-fasta", type=str, required=True)
    parser.add_argument("--db-fasta", type=str, required=True)
    parser.add_argument("--load-from-checkpoint", type=str, required=True,
                        help="model directory written by "
                             "deepblast_torch.train.checkpoint.save_model")
    parser.add_argument("--output-file", type=str, required=True)
    parser.add_argument("--batch-size", type=int, default=10)
    parser.add_argument("--mesh", choices=["auto", "none"], default="auto",
                        help="shard scoring batches over the ranks of the "
                             "process group when it has more than one")
    parser.add_argument("--pad-multiple", type=int, default=64,
                        help="round padded sequence lengths up to this "
                             "multiple")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    started = args.mesh == "auto" and not dist.is_initialized() and \
        mesh_lib.launched_by_torchrun()
    if started:
        mesh_lib.initialize_distributed()
    try:
        return _search(args)
    finally:
        if started:
            dist.destroy_process_group()


def _search(args):
    from deepblast_torch.data.dataset import FastaDataset
    from deepblast_torch.data.state_utils import pad_sequences
    from deepblast_torch.train.checkpoint import load_model

    me = mesh_lib.rank()
    if not dist.is_initialized() and mesh_lib.launched_by_torchrun():
        me = int(os.environ["RANK"])
    ranks = mesh_lib.world_size() if args.mesh == "auto" else 1
    if ranks == 1 and me != 0:
        return 0                # --mesh none: rank 0 scores everything
    model = load_model(args.load_from_checkpoint, device=args.device)
    ds = FastaDataset(args.query_fasta, args.db_fasta,
                      tokenizer=model.tokenizer)
    pm = max(1, args.pad_multiple)
    full = -(-args.batch_size // ranks) * ranks
    cuda = model.device.type == "cuda"

    def padded(seqs):
        toks, lens = pad_sequences(seqs)
        L = -(-toks.shape[1] // pm) * pm
        return np.pad(toks, ((0, 0), (0, L - toks.shape[1]))), lens

    def dispatch(items):
        """Pad ``items`` to ``full`` rows, score this rank's, gather every
        rank's scores and start their copy to the host."""
        its = items + [items[-1]] * (full - len(items))
        xs, xl = padded([it["x"] for it in its])
        ys, yl = padded([it["y"] for it in its])
        batch = dict(x=xs, y=ys, x_len=xl, y_len=yl)
        if ranks > 1:
            batch = mesh_lib.shard_batch(batch, (ranks, 1),
                                         coordinate=(me, 0))
        dev = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if cuda:
                t = t.pin_memory()
            dev[k] = t.to(model.device, non_blocking=True)
        # the host's lengths beside their copies: the LM counts its valid
        # residues from them without waiting for the card
        scores = model.score_pairs(dict(dev, x_len_host=batch["x_len"],
                                        y_len_host=batch["y_len"]))
        if ranks > 1:
            # each rank's rows into zeros, summed: every rank gets all the
            # scores exactly (gloo reduces CUDA tensors, but gathers none)
            k = full // ranks
            every = torch.zeros(full, dtype=scores.dtype,
                                device=scores.device)
            every[me * k:(me + 1) * k] = scores
            dist.all_reduce(every)
            scores = every
        ready = None
        if cuda:
            host = torch.empty(scores.shape, dtype=scores.dtype,
                               pin_memory=True)
            host.copy_(scores, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            scores = host
        return items, scores, ready, xl, yl

    def drain(pending, out):
        items, scores, ready, xl, yl = pending
        if ready is not None:
            ready.synchronize()
        if out is None:
            return
        for it, s, ql, dl in zip(items, scores.numpy(), xl, yl):
            norm = s / (float(ql) * float(dl))
            out.write(f"{it['qid']}\t{it['dbid']}\t"
                      f"{np.round(s, 4)}\t{np.round(norm, 4)}\n")

    out = open(args.output_file, "w") if me == 0 else None
    try:
        buf, inflight = [], deque()

        def launch(items):
            if len(inflight) >= INFLIGHT:
                drain(inflight.popleft(), out)
            inflight.append(dispatch(items))

        for item in ds:
            buf.append(item)
            if len(buf) >= args.batch_size:
                launch(buf)
                buf = []
        if buf:
            launch(buf)
        while inflight:
            drain(inflight.popleft(), out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
