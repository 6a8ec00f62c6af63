#!/usr/bin/env python3
"""Convert a JAX model directory into a deepblast_torch one.

    python scripts/torch_import_jax_model.py <jax_dir> <out_dir> [--step N]

``<jax_dir>`` is what ``deepblast-train`` writes: ``config.json`` and
orbax ``checkpoints/``.  The script restores it through the JAX package's
own ``load_model`` (``deepblast_tpu/train/checkpoint.py:63-73``: the best
checkpoint, or ``--step``), maps the state with
``deepblast_torch.models.convert.state_dicts_from_jax`` (a finetuned
state's LM included) and writes ``<out_dir>`` with the port's
``save_model``: ``config.json`` and ``model.pt``, which
``deepblast_torch.train.checkpoint.load_model`` serves on the card.  The
optimizer state is not carried over.

``config.json`` gains the port's blocks for the language model:

* ``lm_type="prot_t5"``: ``"t5"``, the geometry the JAX trainer builds
  (ProtT5-XL, ``trainer.py:250-253``) in the compute dtype of its
  ``precision``, read off the restored model;
* ``lm_type="bilstm"``: ``"bilm"``, the BiLM's geometry from the restored
  state's shapes and the name of the JAX model's tokenizer.

A directory that the JAX ``load_model`` cannot reload itself (a model
trained from a BiLM artifact with ``--pretrain-path``, ROADMAP.md C) fails
with the JAX package's error, with a note that names it as such.

The script imports both packages and runs JAX on the CPU;
``deepblast_torch`` itself never imports JAX or orbax.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _lm(jmodel, lm_state):
    """The port LM of the restored JAX model's, or None for the token
    embedding (the port builds that from the config).  A BiLM's missing
    next-token head (the JAX BiLM is initialised through ``encode``, which
    never reads ``linear``; nor does the aligner) is added to ``lm_state``
    as zeros."""
    import jax.numpy as jnp
    import torch

    from deepblast_torch.models import lm as tlm
    from deepblast_tpu.models import lm as jlm
    if isinstance(jmodel.lm, jlm.T5Encoder):
        fields = {k: getattr(jmodel.lm.cfg, k)
                  for k in tlm.T5Config.__dataclass_fields__}
        fields["dtype"] = jnp.dtype(fields["dtype"]).name
        return tlm.T5Encoder(tlm.T5Config(**fields))
    if isinstance(jmodel.lm, jlm.BiLM):
        nin, emb = lm_state["embed.weight"].shape
        hidden = lm_state["lstm0.weight_hh_l0"].shape[1]
        nout = jmodel.lm.nout
        lm_state.setdefault("linear.weight", torch.zeros((nout, hidden)))
        lm_state.setdefault("linear.bias", torch.zeros((nout,)))
        return tlm.BiLM(
            nin=nin, nout=lm_state["linear.weight"].shape[0],
            embedding_dim=emb, hidden_dim=hidden,
            num_layers=sum(k.endswith(".weight_hh_l0") for k in lm_state))
    return None


def _tokenizer(jmodel):
    """The port's tokenizer of the JAX model's class."""
    from deepblast_torch.data.alphabet import TOKENIZERS
    name = type(jmodel.tokenizer).__name__
    for cls in TOKENIZERS.values():
        if cls.__name__ == name:
            return cls()
    raise ValueError(f"the port has no tokenizer {name}: expected one of "
                     f"{sorted(c.__name__ for c in TOKENIZERS.values())}")


def import_jax_model(jax_dir, out_dir, step=None):
    """Restore ``jax_dir`` with the JAX ``load_model`` and write the port's
    model directory ``out_dir``; returns the port's ``DeepBLAST`` (on the
    CPU)."""
    from deepblast_torch.models.convert import state_dicts_from_jax
    from deepblast_torch.train.checkpoint import save_model
    from deepblast_torch.train.trainer import DeepBLAST, DeepBLASTConfig
    from deepblast_tpu.train.checkpoint import load_model as jax_load_model
    try:
        jmodel = jax_load_model(jax_dir, step=step)
    except Exception as e:
        e.add_note(f"raised by the JAX package's load_model "
                   f"(deepblast_tpu/train/checkpoint.py) on {jax_dir}: the "
                   f"JAX package cannot reload this directory, so it cannot "
                   f"be converted")
        raise
    sd = state_dicts_from_jax(jmodel.state)
    with open(os.path.join(jax_dir, "config.json")) as f:
        config = DeepBLASTConfig.from_json(f.read())
    model = DeepBLAST(config, tokenizer=_tokenizer(jmodel),
                      lm=_lm(jmodel, sd["lm"]), lm_params=sd["lm"],
                      device="cpu")
    model.aligner.load_state_dict(sd["aligner"])
    save_model(model, out_dir)
    return model


def main(argv=None):
    parser = argparse.ArgumentParser(
        "torch_import_jax_model",
        description="Convert a deepblast-train model directory (orbax "
                    "checkpoints) into a deepblast_torch one (model.pt).")
    parser.add_argument("jax_dir")
    parser.add_argument("out_dir")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step (default: the best)")
    args = parser.parse_args(argv)
    import_jax_model(args.jax_dir, args.out_dir, args.step)
    print(json.dumps({"converted": args.jax_dir, "to": args.out_dir,
                      "files": sorted(os.listdir(args.out_dir))}))
    return 0


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    raise SystemExit(main())
