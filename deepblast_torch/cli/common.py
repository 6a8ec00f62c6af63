"""Shared CLI plumbing of the port (the parts of
``deepblast_tpu/cli/common.py`` that ``cli.train`` needs), with the
``deepblast-train`` defaults, and :func:`build_model`, which loads LM
weights offline: ``--pretrain-path`` takes a raw HuggingFace ProtT5
directory (``pytorch_model.bin``) or an LM artifact of
``cli.convert_lm`` (a ProtT5 or a Bepler BiLM; ``cli/common.py:122-208``).

Every flag of ``deepblast-train`` is taken, with its default.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from deepblast_torch.ops.dp import BACKENDS
from deepblast_torch.train.trainer import DeepBLASTConfig

__all__ = ["MODE_ALIASES", "add_model_args", "add_infra_args",
           "config_from_args", "build_model"]

MODE_ALIASES = {
    "needleman-wunch": "needleman-wunsch",     # reference typo kept working
    "needleman-wunsch": "needleman-wunsch",
    "smith-waterman": "smith-waterman",
}

def add_model_args(parser: argparse.ArgumentParser):
    parser.add_argument("--train-pairs", required=True,
                        help="Training pairs file (TM-align TSV)")
    parser.add_argument("--test-pairs", default=None,
                        help="Testing pairs file (kept in config.json)")
    parser.add_argument("--valid-pairs", required=True,
                        help="Validation pairs file (TM-align TSV)")
    parser.add_argument("--pretrain-path", type=str, default=None,
                        help="a local HF ProtT5 checkpoint directory "
                             "(pytorch_model.bin) or an LM artifact of "
                             "deepblast_torch.cli.convert_lm (ProtT5 or "
                             "Bepler BiLM); sets --lm-type.  Omit to train "
                             "the --lm-type LM from seeded random weights")
    parser.add_argument("--lm-type", type=str, default="embed",
                        choices=["embed", "bilstm", "prot_t5"],
                        help="embed: a token embedding; bilstm: a tied "
                             "BiLM of hidden width embedding-dim / 4 with a "
                             "one-hot identity channel; prot_t5: "
                             "ProtT5-XL geometry")
    parser.add_argument("--vocab-size", type=int, default=32)
    parser.add_argument("--embedding-dim", type=int, default=1024)
    parser.add_argument("--hidden-dim", type=int, default=1024)
    parser.add_argument("--layers", type=int, default=2,
                        help="Number of head layers (default 2)")
    parser.add_argument("--k-size", type=int, default=5,
                        help="CNN kernel width")
    parser.add_argument("--layer-type", type=str, default="cnn",
                        choices=["cnn", "rnn"])
    parser.add_argument("--dropout", type=float, default=0.5)
    parser.add_argument("--loss", type=str, default="cross_entropy",
                        choices=["sse", "path", "cross_entropy"])
    parser.add_argument("--learning-rate", type=float, default=5e-5)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--mode", "--alignment-mode", dest="alignment_mode",
                        type=str, default="needleman-wunsch")
    parser.add_argument("--operator", type=str, default="softmax",
                        choices=["softmax", "sparsemax", "hardmax"])
    parser.add_argument("--backend", type=str, default=None,
                        choices=[*BACKENDS],
                        help="DP passes (default: pallas_bm's stored "
                             "differences); pallas and pallas_long store the "
                             "soft-argmax streams and train pairs past the "
                             "default kernels' limit (S = 6,144 slots; "
                             "theirs 32,768 on an H100); scan runs the "
                             "recursions as plain PyTorch operations in the "
                             "inputs' dtype, with no slot limit, slowly")
    # type=bool as deepblast-train's parser: any non-empty value is True
    parser.add_argument("--finetune", type=bool, default=False,
                        help="train the LM's weights with the aligner")
    parser.add_argument("--mask-gaps", type=bool, default=True)
    parser.add_argument("--scheduler", type=str, default="cosine")
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--visualization-fraction", type=float, default=0.1,
                        help="share of the first validation batch's pairs "
                             "(at most 2) logged as figures and text each "
                             "epoch")
    parser.add_argument("--max-len", type=int, default=1024)
    parser.add_argument("-o", "--output-directory", required=True,
                        help="Output directory of model results")
    return parser


def add_infra_args(parser: argparse.ArgumentParser):
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="average the gradients of this many steps "
                             "per update (optax.MultiSteps)")
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="copy this many same-shape batches to the "
                             "device at once and issue their steps back to "
                             "back, reading their losses once")
    parser.add_argument("--grad-clip", type=float, default=10.0)
    parser.add_argument("--nodes", type=int, default=1,
                        help="processes in all (one a GPU) with "
                             "--coordinator")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="torch.distributed coordinator address "
                             "host:port (multi-process; rank 0 listens "
                             "there)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank with --coordinator")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel mesh width (replicated "
                             "work, as in deepblast-train)")
    parser.add_argument("--load-from-checkpoint", type=str, default=None,
                        help="a checkpoints/ directory of an earlier run to "
                             "resume from (its best state)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--precision", type=str, default="32",
                        choices=("32", "bf16", "16"),
                        help="compute dtype of the T5 LM's and the "
                             "aligner's matmuls (parameters and the DP "
                             "stay float32)")
    parser.add_argument("--dp-bf16-residuals",
                        action=argparse.BooleanOptionalAction,
                        default="auto",
                        help="store the DP kernels' difference-residual "
                        "streams (Dx, Dm, Dxd, Dmd) in bf16: half their "
                        "bytes, ~0.4%% soft-argmax perturbation in the "
                        "reverse passes, the recurrences fp32.  Default "
                        "auto: on for the pallas backends (pallas_bm, the "
                        "default; pallas and pallas_long ignore the menu), "
                        "off for scan, as deepblast-train; "
                        "--no-dp-bf16-residuals forces fp32 streams")
    parser.add_argument("--dp-i16-streams", action="store_true",
                        help="store the DP input streams (and the decode "
                        "path's expectation stream) in int16 fixed point "
                        "(saturating at +-16; <2e-3 E perturbation).  The "
                        "training VJP keeps cotangent and expectation "
                        "streams in float (unbounded), so only the input "
                        "quantization touches gradients")
    parser.add_argument("--dp-decode-menu", choices=["default", "fast"],
                        default="default",
                        help="storage menu of the align() decode: 'fast' = "
                        "bf16 difference residuals + int16 fixed-point "
                        "expectation stream; 'default' inherits the "
                        "training menu.  Decode-only; training and scoring "
                        "are untouched")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda, or cpu)")
    return parser


def config_from_args(args) -> DeepBLASTConfig:
    """The config of a parsed command line."""
    mode = MODE_ALIASES.get(args.alignment_mode, args.alignment_mode)
    return DeepBLASTConfig(
        embedding_dim=args.embedding_dim,
        hidden_dim=args.hidden_dim,
        layers=args.layers,
        k_size=args.k_size,
        dropout=args.dropout,
        layer_type=args.layer_type,
        alignment_mode=mode,
        operator=args.operator,
        backend=args.backend,
        lm_type=_pretrained_lm_type(args),
        vocab_size=args.vocab_size,
        finetune=bool(args.finetune),
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        epochs=args.epochs,
        scheduler=args.scheduler,
        loss=args.loss,
        grad_clip=getattr(args, "grad_clip", None),
        grad_accum=getattr(args, "grad_accum", 1),
        steps_per_dispatch=getattr(args, "steps_per_dispatch", 1),
        mask_gaps=bool(args.mask_gaps),
        seed=getattr(args, "seed", 0),
        precision=getattr(args, "precision", "32"),
        dp_bf16_residuals=getattr(args, "dp_bf16_residuals", "auto"),
        dp_i16_streams=getattr(args, "dp_i16_streams", False),
        dp_decode_menu=getattr(args, "dp_decode_menu", "default"),
        train_pairs=args.train_pairs,
        valid_pairs=args.valid_pairs,
        test_pairs=args.test_pairs,
        max_len=args.max_len,
        output_directory=args.output_directory,
        visualization_fraction=args.visualization_fraction,
        tp=getattr(args, "tp", 1),
    )


def _pretrained_lm_type(args):
    """The ``lm_type`` that ``--pretrain-path`` implies: an LM artifact's
    kind, else ProtT5 (a raw HF directory); without it ``--lm-type``."""
    path = getattr(args, "pretrain_path", None)
    if not path:
        return args.lm_type
    from deepblast_torch.models.convert import is_converted_lm
    if is_converted_lm(path):
        with open(os.path.join(path, "manifest.json")) as f:
            return {"prot_t5": "prot_t5", "bilstm": "bilstm"}[
                json.load(f)["kind"]]
    return "prot_t5"


def build_model(config, pretrain_path=None, device=None):
    """A ``DeepBLAST`` on ``device`` (CUDA unless asked otherwise), with
    the LM weights of ``pretrain_path`` when given: an LM artifact
    (``models.convert.load_converted_lm``) or a raw HF ProtT5 directory
    (``models.lm.load_prot_t5``).  An artifact's BiLM sets
    ``embedding_dim`` to its feature width and ``vocab_size`` to its
    alphabet, and the tokenizer to ``UniprotPairTokenizer``: a Bepler BiLM
    embeds Uniprot21 ids, not ProtT5's."""
    from deepblast_torch.data.alphabet import (ProtT5Tokenizer,
                                               UniprotPairTokenizer)
    from deepblast_torch.models.convert import (is_converted_lm,
                                                load_converted_lm)
    from deepblast_torch.models.lm import BiLM, load_prot_t5
    from deepblast_torch.train.trainer import DeepBLAST
    tokenizer = ProtT5Tokenizer()
    lm = lm_params = None
    if pretrain_path:
        if is_converted_lm(pretrain_path):
            lm, lm_params = load_converted_lm(pretrain_path)
            if isinstance(lm, BiLM):
                config = dataclasses.replace(
                    config, embedding_dim=lm.hidden_size, vocab_size=lm.nin)
                tokenizer = UniprotPairTokenizer()
        else:
            lm, lm_params = load_prot_t5(pretrain_path)
    return DeepBLAST(config, tokenizer=tokenizer, lm=lm, lm_params=lm_params,
                     device=device)
