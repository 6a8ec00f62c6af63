"""Model checkpoints: ``config.json`` plus a ``torch.save`` state dict
(the serving counterpart of ``deepblast_tpu/train/checkpoint.py``).

A checkpoint directory holds ``config.json`` — the
:class:`~deepblast_torch.train.trainer.DeepBLASTConfig` fields, plus the
T5 geometry under ``"t5"`` when the language model is a T5 encoder — and
``model.pt`` with the ``lm`` and ``aligner`` state dicts.  Best-k
checkpointing during training is the training slice.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from deepblast_torch.models.lm import T5Config, T5Encoder
from deepblast_torch.train.trainer import (DeepBLAST, DeepBLASTConfig,
                                           resolve_device)

__all__ = ["save_model", "load_model"]


def save_model(model: DeepBLAST, directory):
    """Write ``model`` to ``directory`` (created if missing)."""
    os.makedirs(directory, exist_ok=True)
    cfg = dataclasses.asdict(model.config)
    if isinstance(model.lm, T5Encoder):
        cfg["t5"] = dataclasses.asdict(model.lm.cfg)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    torch.save({"lm": model.lm.state_dict(),
                "aligner": model.aligner.state_dict()},
               os.path.join(directory, "model.pt"))


def load_model(directory, device=None, tokenizer=None):
    """Rebuild a :class:`DeepBLAST` from a :func:`save_model` directory on
    ``device`` (CUDA unless asked otherwise)."""
    device = resolve_device(device)
    with open(os.path.join(directory, "config.json")) as f:
        raw = f.read()
    config = DeepBLASTConfig.from_json(raw)
    t5 = json.loads(raw).get("t5")
    lm = T5Encoder(T5Config(**t5), device=device) if t5 else None
    state = torch.load(os.path.join(directory, "model.pt"),
                       map_location=device, weights_only=True)
    model = DeepBLAST(config, tokenizer=tokenizer, lm=lm,
                      lm_params=state["lm"], device=device)
    model.aligner.load_state_dict(state["aligner"])
    return model
