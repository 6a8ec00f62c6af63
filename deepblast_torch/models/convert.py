"""Weights carried across from the JAX package.

:func:`params_from_jax` turns a flax parameter tree of the JAX package —
nested dicts of numpy arrays, with or without the outer ``{"params": ...}``
— into a ``state_dict`` of the matching port module.  The port's modules
use the flax submodule names, so the mapping is by name, leaf by leaf:

* ``Dense`` ``kernel (in, out)`` -> ``Linear.weight (out, in)``, ``bias`` as is;
* ``Conv`` ``kernel (k, in, out)`` -> ``Conv1d.weight (out, in, k)``;
* ``Embed`` ``embedding`` -> ``Embedding.weight``;
* ``relative_attention_bias (buckets, heads)`` -> ``Embedding(buckets,
  heads).weight``;
* RMSNorm ``weight`` as is.

It covers :class:`~deepblast_torch.models.aligner.NeuralAligner` (CNN and
linear heads) and :class:`~deepblast_torch.models.lm.T5Encoder` /
:class:`~deepblast_torch.models.lm.TokenEmbed`.  :func:`state_dicts_from_jax`
takes a JAX ``TrainState`` (or its ``params`` and ``lm_params``) whole:
the aligner from ``params["aligner"]`` and the LM from ``params["lm"]``
after a ``finetune`` init (``trainer.py:317-319``, where ``lm_params`` is
left empty), else from ``lm_params``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "state_dicts_from_jax"]

# flax auto-names of unnamed submodules -> the port's attribute names
_RENAMES = {"Dense_0": "linear", "Embed_0": "embed"}


def _tensor(a, dtype):
    t = torch.tensor(np.asarray(a))   # a copy: flax leaves are read-only
    return t if dtype is None else t.to(dtype)


def params_from_jax(tree, dtype=None):
    """flax parameter tree -> port ``state_dict`` (see module docstring).
    ``dtype`` optionally casts every tensor."""
    if isinstance(tree, Mapping) and set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}

    def walk(node, prefix):
        for name, v in node.items():
            name = _RENAMES.get(name, name)
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{name}.")
                continue
            a = np.asarray(v)
            if name == "kernel":
                a = a.T if a.ndim == 2 else a.transpose(2, 1, 0)
                sd[f"{prefix}weight"] = _tensor(a, dtype)
            elif name in ("embedding", "weight"):
                sd[f"{prefix}weight"] = _tensor(a, dtype)
            elif name == "bias":
                sd[f"{prefix}bias"] = _tensor(a, dtype)
            elif name == "relative_attention_bias":
                sd[f"{prefix}{name}.weight"] = _tensor(a, dtype)
            else:
                raise KeyError(f"no port counterpart for flax leaf "
                               f"{prefix}{name}")

    walk(tree, "")
    return sd


def state_dicts_from_jax(params, lm_params=None, dtype=None):
    """``{"aligner": state_dict, "lm": state_dict}`` of a JAX model: from a
    ``TrainState`` (``params`` with ``.params`` and ``.lm_params``) or from
    its ``params`` and ``lm_params`` trees.  A finetuned state keeps the LM
    (token embedding or T5) under ``params["lm"]``."""
    if hasattr(params, "lm_params"):
        params, lm_params = params.params, params.lm_params
    lm = params["lm"] if "lm" in params else lm_params
    return {"aligner": params_from_jax(params["aligner"], dtype),
            "lm": params_from_jax(lm, dtype)}
