"""Weights carried across from the JAX package, and the pretrained-LM
artifacts (``deepblast_tpu/models/convert.py``).

:func:`params_from_jax` turns a flax parameter tree of the JAX package —
nested dicts of numpy arrays, with or without the outer ``{"params": ...}``
— into a ``state_dict`` of the matching port module.  The port's modules
use the flax submodule names, so the mapping is by name, leaf by leaf:

* ``Dense`` ``kernel (in, out)`` -> ``Linear.weight (out, in)``, ``bias`` as is;
* ``Conv`` ``kernel (k, in, out)`` -> ``Conv1d.weight (out, in, k)``;
* ``Embed`` ``embedding`` -> ``Embedding.weight``;
* ``relative_attention_bias (buckets, heads)`` -> ``Embedding(buckets,
  heads).weight``;
* RMSNorm ``weight`` as is;
* an ``nn.RNN``'s cell -> a one-layer ``nn.LSTM`` / ``nn.GRU``'s
  ``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0``, ``bias_hh_l0``: the
  gates' kernels transposed and stacked in torch's order.  An
  ``OptimizedLSTMCell`` (``ii, if, ig, io`` kernels; ``hi, hf, hg, ho``
  kernels and biases) in the order (i, f, g, o), its biases as
  ``bias_hh_l0`` and ``bias_ih_l0`` zero; a ``GRUCell`` (``ir, iz, in``
  kernels and biases; ``hr, hz`` kernels; ``hn`` kernel and bias) in the
  order (r, z, n), ``bias_ih_l0 = [b_ir, b_iz, b_in]`` and ``bias_hh_l0 =
  [0, 0, b_hn]`` (torch's GRU puts ``b_hn`` inside ``r * (...)``, as flax).
  A cell built in ``setup`` sits under its RNN's name (the BiLM's
  ``lstm{i}/cell``); one built inside a compact ``__call__`` sits beside
  the RNNs under its own auto-name, in the order the cells were made
  (``StackedRNN``'s ``OptimizedLSTMCell_{k}`` / ``GRUCell_{k}``: ``fwd{k //
  2}`` for even ``k``, ``bwd{k // 2}`` for odd).

It covers :class:`~deepblast_torch.models.aligner.NeuralAligner` (CNN,
RNN and linear heads), the heads of ``models/heads.py`` and the LMs of
``models/lm.py``.  :func:`state_dicts_from_jax` takes a JAX ``TrainState``
(or its ``params`` and ``lm_params``) whole: the aligner from
``params["aligner"]`` and the LM from ``params["lm"]`` after a
``finetune`` init (``trainer.py:317-319``, where ``lm_params`` is left
empty), else from ``lm_params``.  A JAX BiLM initialised through
``encode`` (the trainer's init) has no ``linear``: its state dict lacks
``linear.weight`` and ``linear.bias``.

The LM artifact (``convert.py:53-312``, format ``deepblast-tpu-lm/1``):
a directory with ``params.npz``, the flax tree flattened to ``/``-joined
keys (bf16 storage as the ``uint16`` bit view under ``<key>::bf16``,
rounded to nearest even as ``jnp.asarray(v, jnp.bfloat16)`` rounds), and
``manifest.json`` (kind, geometry, parameter count, source, storage
dtype).  The port writes and reads the same bytes as the JAX package, so
an artifact of either loads in the other bit for bit; :func:`load_converted_lm`
goes through :func:`params_from_jax`.  :func:`convert_checkpoint` turns a
HuggingFace ``T5EncoderModel`` state dict or a Bepler ``lstm2x.pt`` into
one, numpy and torch only.
"""

from __future__ import annotations

import json
import os
import re
from collections.abc import Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "state_dicts_from_jax", "MANIFEST_FORMAT",
           "hf_t5_encoder_key_shapes", "infer_t5_config",
           "validate_hf_t5_state_dict", "bilm_key_shapes",
           "bepler_bilm_tree", "hf_t5_encoder_tree", "save_converted_lm",
           "load_converted_lm", "is_converted_lm", "detect_kind",
           "convert_checkpoint"]

MANIFEST_FORMAT = "deepblast-tpu-lm/1"

# flax auto-names of unnamed submodules -> the port's attribute names
_RENAMES = {"Dense_0": "linear", "Embed_0": "embed"}
# an RNN cell's gates in torch's row order: (input-side, hidden-side) names
_LSTM_GATES = [("ii", "hi"), ("if", "hf"), ("ig", "hg"), ("io", "ho")]
_GRU_GATES = [("ir", "hr"), ("iz", "hz"), ("in", "hn")]
# auto-named cells of StackedRNN's compact __call__ (see the docstring)
_CELL_NAMES = re.compile(r"(?:OptimizedLSTMCell|GRUCell)_(\d+)$")


def _tensor(v, dtype):
    """A leaf as a new tensor: a torch tensor copied, a numpy (or JAX)
    array copied, bf16 ones (``ml_dtypes.bfloat16``) by their bits."""
    if torch.is_tensor(v):
        t = v.detach().clone()
    else:
        a = np.asarray(v)
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16) \
            if a.dtype.name == "bfloat16" else torch.tensor(a)
    return t if dtype is None else t.to(dtype)


def _rnn_cell(cell, prefix, dtype):
    """The one-layer ``nn.LSTM`` / ``nn.GRU`` tensors of a flax cell."""
    gates = _LSTM_GATES if "ii" in cell else _GRU_GATES

    def stack(side, leaf):
        parts = []
        for names in gates:
            p = cell[names[side]]
            if leaf == "kernel":
                parts.append(_tensor(p["kernel"], dtype).T)
            elif "bias" in p:
                parts.append(_tensor(p["bias"], dtype))
            else:                           # a gate without a bias
                parts.append(torch.zeros_like(
                    _tensor(p["kernel"], dtype)[0]))
        return torch.cat(parts, dim=0)

    w_ih, w_hh = stack(0, "kernel"), stack(1, "kernel")
    if gates is _LSTM_GATES:
        b_hh = stack(1, "bias")
        b_ih = torch.zeros_like(b_hh)
    else:
        b_ih, b_hh = stack(0, "bias"), stack(1, "bias")
    return {f"{prefix}weight_ih_l0": w_ih, f"{prefix}weight_hh_l0": w_hh,
            f"{prefix}bias_ih_l0": b_ih, f"{prefix}bias_hh_l0": b_hh}


def params_from_jax(tree, dtype=None):
    """flax parameter tree -> port ``state_dict`` (see module docstring).
    ``dtype`` optionally casts every tensor."""
    if isinstance(tree, Mapping) and set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}

    def walk(node, prefix):
        for name, v in node.items():
            name = _RENAMES.get(name, name)
            if name == "cell" and isinstance(v, Mapping):
                sd.update(_rnn_cell(v, prefix, dtype))
                continue
            cell = _CELL_NAMES.match(name)
            if cell:
                k = int(cell.group(1))
                owner = f"{'bwd' if k % 2 else 'fwd'}{k // 2}"
                sd.update(_rnn_cell(v, f"{prefix}{owner}.", dtype))
                continue
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{name}.")
                continue
            t = _tensor(v, dtype)
            if name == "kernel":
                t = t.T if t.dim() == 2 else t.permute(2, 1, 0)
                sd[f"{prefix}weight"] = t.contiguous()
            elif name in ("embedding", "weight"):
                sd[f"{prefix}weight"] = t
            elif name == "bias":
                sd[f"{prefix}bias"] = t
            elif name == "relative_attention_bias":
                sd[f"{prefix}{name}.weight"] = t
            else:
                raise KeyError(f"no port counterpart for flax leaf "
                               f"{prefix}{name}")

    walk(tree, "")
    return sd


def state_dicts_from_jax(params, lm_params=None, dtype=None):
    """``{"aligner": state_dict, "lm": state_dict}`` of a JAX model: from a
    ``TrainState`` (``params`` with ``.params`` and ``.lm_params``) or from
    its ``params`` and ``lm_params`` trees.  A finetuned state keeps the LM
    (token embedding, BiLM or T5) under ``params["lm"]``."""
    if hasattr(params, "lm_params"):
        params, lm_params = params.params, params.lm_params
    lm = params["lm"] if "lm" in params else lm_params
    return {"aligner": params_from_jax(params["aligner"], dtype),
            "lm": params_from_jax(lm, dtype)}


# ---------------------------------------------------------------------------
# the HF T5 and Bepler layouts
# ---------------------------------------------------------------------------

def hf_t5_encoder_key_shapes(cfg):
    """Key -> shape of the HF ``T5EncoderModel`` state-dict keys that
    :func:`hf_t5_encoder_tree` reads (torch ``Linear`` weights ``(out,
    in)``; ``convert.py:53-83``)."""
    inner = cfg.num_heads * cfg.d_kv
    ks = {
        "shared.weight": (cfg.vocab_size, cfg.d_model),
        "encoder.final_layer_norm.weight": (cfg.d_model,),
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        ks[f"{pre}.0.SelfAttention.q.weight"] = (inner, cfg.d_model)
        ks[f"{pre}.0.SelfAttention.k.weight"] = (inner, cfg.d_model)
        ks[f"{pre}.0.SelfAttention.v.weight"] = (inner, cfg.d_model)
        ks[f"{pre}.0.SelfAttention.o.weight"] = (cfg.d_model, inner)
        ks[f"{pre}.0.layer_norm.weight"] = (cfg.d_model,)
        ks[f"{pre}.1.layer_norm.weight"] = (cfg.d_model,)
        if cfg.feed_forward_proj == "gated-gelu":
            ks[f"{pre}.1.DenseReluDense.wi_0.weight"] = (cfg.d_ff,
                                                         cfg.d_model)
            ks[f"{pre}.1.DenseReluDense.wi_1.weight"] = (cfg.d_ff,
                                                         cfg.d_model)
        else:
            ks[f"{pre}.1.DenseReluDense.wi.weight"] = (cfg.d_ff,
                                                       cfg.d_model)
        ks[f"{pre}.1.DenseReluDense.wo.weight"] = (cfg.d_model, cfg.d_ff)
        if i == 0:
            ks[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = (
                cfg.relative_attention_num_buckets, cfg.num_heads)
    return ks


def _shape(v):
    return tuple(v.shape)


def infer_t5_config(sd):
    """The encoder geometry of a HF state dict (``convert.py:90-112``)."""
    from deepblast_torch.models.lm import T5Config
    vocab, d_model = _shape(sd["shared.weight"])
    layers = set()
    gated = False
    for k in sd:
        if k.startswith("encoder.block."):
            layers.add(int(k.split(".")[2]))
        if "DenseReluDense.wi_0" in k:
            gated = True
    inner = _shape(sd["encoder.block.0.layer.0.SelfAttention.q.weight"])[0]
    num_buckets, num_heads = _shape(sd[
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias"
        ".weight"])
    wi = ("encoder.block.0.layer.1.DenseReluDense.wi_0.weight" if gated
          else "encoder.block.0.layer.1.DenseReluDense.wi.weight")
    return T5Config(
        vocab_size=vocab, d_model=d_model, d_kv=inner // num_heads,
        d_ff=_shape(sd[wi])[0], num_layers=max(layers) + 1,
        num_heads=num_heads, relative_attention_num_buckets=num_buckets,
        feed_forward_proj="gated-gelu" if gated else "relu")


def validate_hf_t5_state_dict(sd, cfg):
    """``(missing, mismatched, extra)`` of ``sd`` against
    :func:`hf_t5_encoder_key_shapes`; extra keys (decoder weights, the
    tied ``encoder.embed_tokens.weight``, ``lm_head``) are ignored by the
    converter."""
    expect = hf_t5_encoder_key_shapes(cfg)
    missing = [k for k in expect if k not in sd]
    mismatched = [(k, _shape(sd[k]), expect[k]) for k in expect
                  if k in sd and _shape(sd[k]) != expect[k]]
    extra = [k for k in sd if k not in expect]
    return missing, mismatched, extra


def bilm_key_shapes(nin=22, nout=21, embedding_dim=21, hidden_dim=1024,
                    num_layers=2):
    """Key -> shape of the Bepler ``lstm2x.pt`` layout
    (``convert.py:128-141``)."""
    ks = {"embed.weight": (nin, embedding_dim),
          "linear.weight": (nout, hidden_dim),
          "linear.bias": (nout,)}
    for i in range(num_layers):
        nin_i = embedding_dim if i == 0 else hidden_dim
        ks[f"rnn.{i}.weight_ih_l0"] = (4 * hidden_dim, nin_i)
        ks[f"rnn.{i}.weight_hh_l0"] = (4 * hidden_dim, hidden_dim)
        ks[f"rnn.{i}.bias_ih_l0"] = (4 * hidden_dim,)
        ks[f"rnn.{i}.bias_hh_l0"] = (4 * hidden_dim,)
    return ks


def _numpy_getter(state_dict):
    def g(key):
        v = state_dict[key]
        return np.asarray(v.detach().cpu().numpy()
                          if hasattr(v, "detach") else v)
    return g


def bepler_bilm_tree(state_dict, num_layers=2):
    """The JAX BiLM's flax tree of a Bepler state dict (the JAX package's
    ``convert_bepler_bilm``, ``lm.py:113-146``): each torch gate chunk
    transposed into an ``(in, H)`` kernel, the two bias chunks summed."""
    g = _numpy_getter(state_dict)
    p = {"embed": {"embedding": g("embed.weight")},
         "linear": {"kernel": g("linear.weight").T,
                    "bias": g("linear.bias")}}
    for i in range(num_layers):
        w_ih = g(f"rnn.{i}.weight_ih_l0")
        w_hh = g(f"rnn.{i}.weight_hh_l0")
        b = g(f"rnn.{i}.bias_ih_l0") + g(f"rnn.{i}.bias_hh_l0")
        H = w_hh.shape[1]
        cell = {}
        for n, (gi, gh) in enumerate(_LSTM_GATES):
            rows = slice(n * H, (n + 1) * H)
            cell[gi] = {"kernel": w_ih[rows].T}
            cell[gh] = {"kernel": w_hh[rows].T, "bias": b[rows]}
        p[f"lstm{i}"] = {"cell": cell}
    return {"params": p}


def hf_t5_encoder_tree(state_dict, cfg):
    """The JAX ``T5Encoder``'s flax tree of a HF state dict (the JAX
    package's ``convert_hf_t5_encoder``, ``lm.py:336-374``)."""
    g = _numpy_getter(state_dict)

    def lin(key):
        return {"kernel": g(key).T}

    p = {"embed": {"embedding": g("shared.weight")},
         "ln_final": {"weight": g("encoder.final_layer_norm.weight")}}
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        attn = {n: lin(f"{pre}.0.SelfAttention.{n}.weight")
                for n in ("q", "k", "v", "o")}
        if i == 0:
            attn["relative_attention_bias"] = g(
                f"{pre}.0.SelfAttention.relative_attention_bias.weight")
        ff_names = ("wi_0", "wi_1", "wo") \
            if cfg.feed_forward_proj == "gated-gelu" else ("wi", "wo")
        ff = {n: lin(f"{pre}.1.DenseReluDense.{n}.weight") for n in ff_names}
        p[f"block{i}"] = {
            "ln_attn": {"weight": g(f"{pre}.0.layer_norm.weight")},
            "attn": attn,
            "ln_ff": {"weight": g(f"{pre}.1.layer_norm.weight")},
            "ff": ff,
        }
    return {"params": p}


# ---------------------------------------------------------------------------
# the on-disk artifact
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _bf16_bits(v):
    """float32 / float64 numpy -> the uint16 bits of its bf16 rounding (to
    nearest even)."""
    t = torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def save_converted_lm(directory, kind, params, config, source=None,
                      dtype=None):
    """Write ``params.npz`` (the flax tree ``params``) and
    ``manifest.json``; ``config`` is a JSON-able dict of the geometry
    (``T5Config`` fields / BiLM dims); ``dtype`` ``"bfloat16"`` stores the
    float leaves as bf16 (``convert.py:170-201``)."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(params)
    if dtype is not None and str(dtype) not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported storage dtype {dtype!r} "
                         "(float32 or bfloat16)")
    bf16 = dtype is not None and str(dtype) == "bfloat16"
    stored = {}
    for k, v in flat.items():
        if bf16 and v.dtype in (np.float32, np.float64):
            v, k = _bf16_bits(v), k + "::bf16"
        stored[k] = v
    np.savez(os.path.join(directory, "params.npz"), **stored)
    manifest = {
        "format": MANIFEST_FORMAT,
        "kind": kind,
        "config": config,
        "n_params": int(sum(v.size for v in flat.values())),
        "source": source,
        "storage_dtype": "bfloat16" if bf16 else "float32",
    }
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_converted_lm(directory, device=None):
    """``(module, state_dict)`` of a converted-LM directory
    (``convert.py:204-232``): a float32 :class:`~deepblast_torch.models.lm.T5Encoder`
    (``"prot_t5"``) or :class:`~deepblast_torch.models.lm.BiLM`
    (``"bilstm"``) on ``device``, and its weights (bf16 tensors from a bf16
    artifact, the values it stores).  A CUDA ``device`` sets
    ``models.exact_cuda_math``'s flags (TF32 off)."""
    from deepblast_torch.models import exact_cuda_math
    from deepblast_torch.models.lm import BiLM, T5Config, T5Encoder
    if torch.device(device or "cpu").type == "cuda":
        exact_cuda_math()
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != MANIFEST_FORMAT:
        raise ValueError(f"{directory} is not a deepblast-tpu LM artifact")
    with np.load(os.path.join(directory, "params.npz")) as data:
        flat = {}
        for k in data.files:
            v = data[k]
            if k.endswith("::bf16"):
                flat[k[:-6]] = torch.from_numpy(v.view(np.int16)).view(
                    torch.bfloat16)
            else:
                flat[k] = v
    cfg = manifest["config"]
    if manifest["kind"] == "prot_t5":
        model = T5Encoder(T5Config(**{
            k: v for k, v in cfg.items()
            if k in T5Config.__dataclass_fields__}), device=device)
    elif manifest["kind"] == "bilstm":
        model = BiLM(nin=cfg["nin"], nout=cfg["nout"],
                     embedding_dim=cfg["embedding_dim"],
                     hidden_dim=cfg["hidden_dim"],
                     num_layers=cfg["num_layers"], device=device)
    else:
        raise ValueError(f"unknown LM kind {manifest['kind']!r}")
    return model, params_from_jax(_unflatten(flat))


def is_converted_lm(path):
    """True only for an LM artifact of this format: a raw HF snapshot can
    hold an unrelated ``manifest.json`` (``convert.py:235-246``)."""
    mf = os.path.join(path, "manifest.json")
    if not (os.path.isdir(path) and os.path.exists(mf)):
        return False
    try:
        with open(mf) as f:
            return json.load(f).get("format") == MANIFEST_FORMAT
    except (OSError, ValueError):
        return False


# ---------------------------------------------------------------------------
# conversion of a downloaded checkpoint
# ---------------------------------------------------------------------------

def _load_torch_sd(path):
    """``(state dict, file)`` of a checkpoint file or a HF directory's
    ``pytorch_model.bin``.  Read with ``weights_only=True`` (the JAX
    package unpickles anything): a whole-module pickle loads only when its
    classes are allow-listed (``torch.serialization.add_safe_globals``)."""
    f = path
    if os.path.isdir(path):
        f = os.path.join(path, "pytorch_model.bin")
        if not os.path.exists(f):
            raise FileNotFoundError(
                f"{path} has no pytorch_model.bin — pass the checkpoint "
                "file directly")
    sd = torch.load(f, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):            # whole-module pickles
        sd = sd.state_dict()
    return dict(sd.items()), f


def detect_kind(sd):
    """``"prot_t5"`` or ``"bilstm"`` by the state dict's keys."""
    if any(k.startswith("encoder.block.") for k in sd):
        return "prot_t5"
    if any(k.startswith("rnn.") for k in sd):
        return "bilstm"
    raise ValueError(
        "unrecognised checkpoint layout: expected HF T5EncoderModel keys "
        "(encoder.block.*) or Bepler BiLM keys (rnn.*)")


def convert_checkpoint(checkpoint, output, kind="auto", dtype=None,
                       strict=True):
    """Convert a downloaded pretrained checkpoint into an LM artifact in
    ``output``; returns the manifest (``convert.py:278-312``)."""
    from deepblast_torch.models.lm import _bilm_geometry
    sd, source = _load_torch_sd(checkpoint)
    if kind == "auto":
        kind = detect_kind(sd)
    if kind == "prot_t5":
        cfg = infer_t5_config(sd)
        missing, mismatched, _ = validate_hf_t5_state_dict(sd, cfg)
        if missing or mismatched:
            msg = (f"state dict does not match the expected HF T5 encoder "
                   f"layout: missing={missing[:5]} "
                   f"mismatched={mismatched[:5]}")
            if strict:
                raise ValueError(msg)
            print(f"WARNING: {msg}")
        params = hf_t5_encoder_tree(sd, cfg)
        config = {k: getattr(cfg, k) for k in (
            "vocab_size", "d_model", "d_kv", "d_ff", "num_layers",
            "num_heads", "relative_attention_num_buckets",
            "relative_attention_max_distance", "feed_forward_proj")}
    elif kind == "bilstm":
        nin, nout, emb, hidden, nl = _bilm_geometry(sd)
        params = bepler_bilm_tree(sd, num_layers=nl)
        config = {"nin": nin, "nout": nout, "embedding_dim": emb,
                  "hidden_dim": hidden, "num_layers": nl}
    else:
        raise ValueError(f"unknown kind {kind!r}")
    return save_converted_lm(output, kind, params, config,
                             source=os.path.abspath(source), dtype=dtype)
