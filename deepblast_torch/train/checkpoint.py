"""Model directories and training checkpoints
(``deepblast_tpu/train/checkpoint.py``).

A model directory holds ``config.json`` — the
:class:`~deepblast_torch.train.trainer.DeepBLASTConfig` fields, plus the
T5 geometry and compute dtype under ``"t5"`` when the language model is a
T5 encoder, or the BiLM's geometry and the name of its tokenizer
(``data.alphabet.TOKENIZERS``) under ``"bilm"`` when it is a BiLM
(:func:`save_config`) — and ``model.pt`` with the ``lm`` and ``aligner``
state dicts (:func:`save_model`).  So a model trained from an LM artifact
reloads with that LM and its tokenizer: a Bepler-geometry BiLM reads
Uniprot21 ids, not the ProtT5 ids of the config's own BiLM.  Training adds
``checkpoints/``, where a :class:`Checkpointer` keeps the best *k*
training states by a monitored metric, one subdirectory per step with
``state.pt`` (``DeepBLAST.train_state``: step, aligner, with ``finetune``
the LM, optimizer and schedule state, with ``grad_accum`` the running
gradient mean and its count) and ``metrics.json``.  :func:`load_model`
rebuilds the model from ``model.pt`` and, when ``checkpoints/`` holds any,
takes the aligner, a finetuned LM and the training state from the best
checkpoint.  A JAX model directory (``deepblast-train``'s orbax
``checkpoints/``) is refused: ``scripts/torch_import_jax_model.py``
converts it.  Under a process group only rank 0 writes
(:class:`Checkpointer`'s ``save``, :func:`save_config`,
:func:`save_model`); every rank reads.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil

import torch

from deepblast_torch.data.alphabet import TOKENIZERS, ProtT5Tokenizer
from deepblast_torch.models.lm import BiLM, T5Config, T5Encoder
from deepblast_torch.parallel.mesh import is_writer
from deepblast_torch.train.trainer import (DeepBLAST, DeepBLASTConfig,
                                           resolve_device)

__all__ = ["Checkpointer", "save_config", "save_model", "load_model"]

#: the script that converts a JAX model directory into the port's
IMPORT_SCRIPT = "scripts/torch_import_jax_model.py"


class Checkpointer:
    """Writes training states under ``directory`` and keeps the ``keep``
    best by ``monitor`` (lowest first; a state saved without that metric
    is ranked by its ``train_loss``).  Rank 0 alone writes."""

    def __init__(self, directory, keep=3, monitor="validation_loss"):
        self.directory = os.path.abspath(directory)
        if is_writer():
            os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.monitor = monitor

    def _metric(self, metrics):
        return float(metrics.get(self.monitor,
                                 metrics.get("train_loss", math.inf)))

    def steps(self):
        """``[(metric, step), ...]`` of the kept checkpoints, best first."""
        out = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name, "metrics.json")
            if name.isdigit() and os.path.exists(path):
                with open(path) as f:
                    out.append((self._metric(json.load(f)), int(name)))
        return sorted(out)

    def save(self, state, metrics=None):
        """Write ``state`` (a ``DeepBLAST.train_state()``) at its step, then
        delete all but the ``keep`` best (on rank 0; a no-op elsewhere)."""
        if not is_writer():
            return
        step = int(state["step"])
        path = os.path.join(self.directory, str(step))
        os.makedirs(path, exist_ok=True)
        torch.save(state, os.path.join(path, "state.pt"))
        with open(os.path.join(path, "metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in (metrics or {}).items()
                       if isinstance(v, (int, float))}, f)
        for _, old in self.steps()[self.keep:]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def best_step(self):
        kept = self.steps()
        return kept[0][1] if kept else None

    def restore(self, step=None, device=None):
        """The training state at ``step`` (default: the best), with its
        tensors on ``device``."""
        step = self.best_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(os.path.join(self.directory, str(step), "state.pt"),
                          map_location=device, weights_only=True)


def save_config(model: DeepBLAST, directory):
    """Write ``config.json`` for ``model`` to ``directory`` (created if
    missing), on rank 0."""
    if not is_writer():
        return
    os.makedirs(directory, exist_ok=True)
    cfg = dataclasses.asdict(model.config)
    if isinstance(model.lm, T5Encoder):
        cfg["t5"] = dataclasses.asdict(model.lm.cfg)
    if isinstance(model.lm, BiLM):
        names = [k for k, v in TOKENIZERS.items()
                 if type(model.tokenizer) is v]
        if not names:
            raise ValueError(f"config.json cannot name the tokenizer "
                             f"{type(model.tokenizer).__name__}: expected "
                             f"one of {sorted(TOKENIZERS)}")
        lm = model.lm
        cfg["bilm"] = dict(nin=lm.nin, nout=lm.nout,
                           embedding_dim=lm.embedding_dim,
                           hidden_dim=lm.hidden_dim,
                           num_layers=lm.num_layers, tokenizer=names[0])
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)


def save_model(model: DeepBLAST, directory):
    """Write ``model`` (config and weights) to ``directory``, on rank 0."""
    if not is_writer():
        return
    save_config(model, directory)
    torch.save({"lm": model.lm.state_dict(),
                "aligner": model.aligner.state_dict()},
               os.path.join(directory, "model.pt"))


def _bilm_and_tokenizer(config, block, tokenizer, device):
    """The BiLM of a config's ``"bilm"`` block and the tokenizer it
    names (a ``tokenizer`` passed must be of that class).  Without the
    block (a JAX config.json): the config's own BiLM (``DeepBLAST``'s
    ``_build_lm``) and the ProtT5 tokenizer, as the JAX ``load_model``
    builds them, refused when the ProtT5 ids do not fit ``vocab_size``:
    then the JAX model was trained from a BiLM artifact, whose geometry
    and Uniprot21 ids its config.json does not record (ROADMAP.md C)."""
    if block is None:
        tokenizer = tokenizer or ProtT5Tokenizer()
        top = max(tokenizer.vocab.values()) \
            if isinstance(tokenizer, ProtT5Tokenizer) else -1
        if top >= config.vocab_size:
            raise ValueError(
                f"config.json sets lm_type 'bilstm' and vocab_size "
                f"{config.vocab_size} without the port's 'bilm' block: the "
                f"ProtT5 ids reach {top}, past the BiLM's table.  A "
                "JAX model trained from a BiLM artifact (--pretrain-path) "
                "writes such a config, and neither package can rebuild its "
                "LM or its Uniprot21 tokenizer from it; retrain with the "
                "port, which records both")
        return None, tokenizer
    want = TOKENIZERS[block["tokenizer"]]
    if tokenizer is not None and type(tokenizer) is not want:
        raise ValueError(f"this model's BiLM reads the ids of "
                         f"{want.__name__}, not of "
                         f"{type(tokenizer).__name__}")
    lm = BiLM(**{k: v for k, v in block.items() if k != "tokenizer"},
              device=device)
    return lm, tokenizer or want()


def _refuse_orbax(ckpts):
    """Raise when ``ckpts`` holds a step that the JAX package's orbax
    ``Checkpointer`` wrote (``_CHECKPOINT_METADATA`` or ``default/``, no
    ``state.pt``): serving ``init()`` weights in its place would be
    silent."""
    if not os.path.isdir(ckpts):
        return
    for name in sorted(os.listdir(ckpts)):
        step = os.path.join(ckpts, name)
        if name.isdigit() and not os.path.exists(
                os.path.join(step, "state.pt")) and any(
                os.path.exists(os.path.join(step, f))
                for f in ("_CHECKPOINT_METADATA", "default")):
            raise ValueError(
                f"{step} is an orbax checkpoint of the JAX package, which "
                f"deepblast_torch does not read: convert the model "
                f"directory with python {IMPORT_SCRIPT} "
                f"{os.path.dirname(ckpts)} <out_dir>")


def load_model(directory, device=None, tokenizer=None, step=None):
    """Rebuild a :class:`DeepBLAST` from a model directory on ``device``
    (CUDA unless asked otherwise), its LM from the ``"t5"`` or ``"bilm"``
    block of ``config.json`` when there is one, with the tokenizer that
    block names (:func:`_bilm_and_tokenizer`).  Without ``model.pt`` the
    weights come from ``init()`` with the config's seed; with checkpoints,
    the aligner, the LM of a ``finetune`` run and the training state come
    from the best one (or ``step``).  Orbax checkpoints (a JAX model
    directory) raise a ``ValueError`` naming :data:`IMPORT_SCRIPT`."""
    ckpts = os.path.join(directory, "checkpoints")
    _refuse_orbax(ckpts)
    device = resolve_device(device)
    with open(os.path.join(directory, "config.json")) as f:
        raw = f.read()
    config = DeepBLASTConfig.from_json(raw)
    blocks = json.loads(raw)
    lm = None
    if blocks.get("t5"):
        lm = T5Encoder(T5Config(**blocks["t5"]), device=device)
    elif config.lm_type == "bilstm":
        lm, tokenizer = _bilm_and_tokenizer(config, blocks.get("bilm"),
                                            tokenizer, device)
    weights = os.path.join(directory, "model.pt")
    state = torch.load(weights, map_location=device, weights_only=True) \
        if os.path.exists(weights) else None
    model = DeepBLAST(config, tokenizer=tokenizer, lm=lm,
                      lm_params=state["lm"] if state else None,
                      device=device)
    if state:
        model.aligner.load_state_dict(state["aligner"])
    else:
        model.init()
    if os.path.isdir(ckpts) and Checkpointer(ckpts).steps():
        model.load_train_state(Checkpointer(ckpts).restore(step, device))
    return model
