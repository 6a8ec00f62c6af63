"""Seeded random weights of DeepBLAST's model, made on the device in one
draw: one standard normal vector for every random leaf, cut into the
leaves and scaled by each leaf's standard deviation; norms one, biases
zero.  The same seed gives the same weights to the program and to the
reference.

The draws follow the usual initialisation: linear and convolution
weights normal with standard deviation ``1/sqrt(fan_in)``, the token
embedding standard normal, the relative-position table normal(0.02)."""

from __future__ import annotations

import math

import torch

from portbench.traffic import torch_generator

__all__ = ["specs", "make", "model_weights"]


def _t5_specs(lm):
    d, inner, ff = lm["d_model"], lm["num_heads"] * lm["d_kv"], lm["d_ff"]
    out = [("embed.weight", (lm["vocab_size"], d), 1.0)]
    for i in range(lm["num_layers"]):
        p = f"block{i}."
        out.append((p + "ln_attn.weight", (d,), "ones"))
        out += [(p + f"attn.{n}.weight", (inner, d), d ** -0.5) for n in "qkv"]
        out.append((p + "attn.o.weight", (d, inner), inner ** -0.5))
        if i == 0:
            out.append((p + "attn.relative_attention_bias.weight",
                        (lm["relative_attention_num_buckets"],
                         lm["num_heads"]), 0.02))
        out.append((p + "ln_ff.weight", (d,), "ones"))
        out.append((p + "ff.wi.weight", (ff, d), d ** -0.5))
        out.append((p + "ff.wo.weight", (d, ff), ff ** -0.5))
    out.append(("ln_final.weight", (d,), "ones"))
    return out


def _head_specs(heads):
    D, F, k = heads["embedding_dim"], heads["hidden_dim"], heads["k_size"]
    out = []
    for h in ("match_embedding", "gap_embedding"):
        out.append((f"{h}.embed.weight", (D, D), D ** -0.5))
        out.append((f"{h}.embed.bias", (D,), "zeros"))
        for i in range(heads["layers"]):
            cin = D if i == 0 else F
            out.append((f"{h}.conv{i}.weight", (F, cin, k),
                        1 / math.sqrt(cin * k)))
            out.append((f"{h}.conv{i}.bias", (F,), "zeros"))
    return out


def specs(cfg):
    """``(lm_specs, head_specs)``: ``(name, shape, std | "ones" |
    "zeros")`` of every leaf."""
    return _t5_specs(cfg["lm"]), _head_specs(cfg["heads"])


def make(leaf_specs, seed, device, tag):
    """The leaves of ``leaf_specs`` as float32 tensors on ``device``."""
    sizes = [math.prod(s) for _, s, std in leaf_specs
             if not isinstance(std, str)]
    g = torch_generator(seed, tag, device)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for name, shape, std in leaf_specs:
        if std == "ones":
            out[name] = torch.ones(shape, device=device)
        elif std == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape).mul_(std)
            off += n
    return out


def model_weights(cfg, seed, device):
    """Every leaf of configuration ``cfg``'s model for ``seed``, in one
    dict (the reference's view of what :func:`make` gives the program)."""
    lm_specs, head_specs = specs(cfg)
    w = make(lm_specs, seed, device, "lm")
    w.update(make(head_specs, seed, device, "heads"))
    return w
