"""Train the aligner on TM-align pairs (``deepblast_tpu/cli/train.py``).

    python -m deepblast_torch.cli.train --train-pairs train.tsv \\
        --valid-pairs valid.tsv -o out_dir [--lm-type prot_t5] [...]

It writes ``config.json`` to the output directory, trains with
``DeepBLAST.fit`` (metrics to ``<out_dir>/logdir_*/metrics.jsonl``, the
three best states by validation loss to ``<out_dir>/checkpoints/``), and
finally writes ``model.pt``, so that
``deepblast_torch.train.checkpoint.load_model(out_dir)`` serves ``align``
and the search CLI from the best checkpoint.  It runs on ``--device``
(CUDA by default), and data parallel on several GPUs, one process each:

    torchrun --nproc-per-node N -m deepblast_torch.cli.train ...

or, without torchrun, each process with ``--coordinator host:port --nodes
N --process-id r`` (rank 0 listens at the address).  Then ``fit(mesh=
"auto")`` splits each batch over the largest divisor of ``--batch-size``
that fits ``N // --tp`` ranks (``deepblast_tpu/cli/train.py:22-46``;
``--tp`` replicates, as there), rank 0 alone writes the output directory,
and ``--load-from-checkpoint`` restores on every rank.

``--backend pallas_long`` (or ``pallas``) trains through the Q-stream DP
kernels, which take pairs past the default kernels' limit (with
``--max-len 4096``); ``--backend scan`` through the plain operations
of the scan backend, in float32, with no slot limit; the backend is
kept in ``config.json``.  ``--precision bf16`` (or ``16``) computes the T5 LM
and the potentials' contractions in that dtype, ``--finetune True`` trains
the LM too, ``--grad-accum k`` updates every k steps on their mean
gradient, and ``--steps-per-dispatch K`` copies K same-shape batches to
the device at once and issues their steps back to back; all four are kept
in ``config.json``.  ``--lm-type bilstm`` trains a tied BiLM (float32,
cuDNN's LSTM on the card) and ``--layer-type rnn`` bidirectional LSTM
heads; ``--pretrain-path`` loads LM weights offline, from a raw HF ProtT5
directory or an artifact of ``cli.convert_lm`` (a Bepler BiLM artifact
switches the tokenizer to Uniprot21 ids and sizes the heads from it), and
``config.json`` with ``model.pt`` keep the LM's geometry and weights.
``--visualization-fraction`` (default 0.1) sets the share of the first
validation batch's pairs logged as figures and text each epoch; the logs
go to TensorBoard event files too where ``tensorboard`` is installed.
"""

from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from deepblast_torch.cli.common import (add_infra_args, add_model_args,
                                        build_model, config_from_args)
from deepblast_torch.parallel import mesh as mesh_lib


def parse_args(argv=None):
    parser = argparse.ArgumentParser("deepblast-train")
    add_infra_args(parser)
    add_model_args(parser)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    config = config_from_args(args)
    # join the process group the command line or torchrun describes,
    # unless the caller already has
    started = not dist.is_initialized() and (
        args.coordinator is not None or mesh_lib.launched_by_torchrun())
    if started:
        mesh_lib.initialize_distributed(args.coordinator, args.nodes,
                                        args.process_id)
    try:
        return _train(args, config)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, config):
    from deepblast_torch.train.checkpoint import (Checkpointer, save_config,
                                                  save_model)
    from deepblast_torch.utils.logging import MetricsLogger

    model = build_model(config, args.pretrain_path, device=args.device).init()
    if args.load_from_checkpoint:
        model.load_train_state(Checkpointer(args.load_from_checkpoint)
                               .restore(device=model.device))
    out = args.output_directory
    save_config(model, out)
    logger = MetricsLogger(out)
    ckpt = Checkpointer(os.path.join(out, "checkpoints"))
    try:
        _, history = model.fit(logger=logger, checkpointer=ckpt,
                               mesh="auto")
    finally:
        logger.close()
    save_model(model, out)
    print(f"final: {history[-1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
