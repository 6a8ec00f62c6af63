"""The T5 encoder stack (Raffel et al. 2020; ProtT5-XL-UniRef50, Elnaggar
et al. 2021) as plain tensor operations over a weight dict.

Weights are named ``embed.weight``, ``block{i}.ln_attn.weight``,
``block{i}.attn.{q,k,v,o}.weight`` (``(out, in)``),
``block0.attn.relative_attention_bias.weight`` (``(buckets, heads)``,
shared by every block), ``block{i}.ln_ff.weight``,
``block{i}.ff.{wi,wo}.weight`` and ``ln_final.weight``.  T5's attention
has no ``1/sqrt(d_kv)`` scaling; its norms are RMS norms without a mean;
the feed-forward is ``relu`` (ProtT5-XL's ``feed_forward_proj``).  Keys
past a sequence's length are masked.  DeepBLAST reads the encoder's
per-residue output and zeroes pad positions; so does this function.
"""

from __future__ import annotations

import math

import torch

__all__ = ["relative_buckets", "encode"]


def relative_buckets(L, num_buckets, max_distance, device):
    """``(L, L)`` bucket ids of key-minus-query offsets, T5's bidirectional
    scheme, worked out in float64 on the host."""
    half = num_buckets // 2
    exact = half // 2
    out = []
    for d in range(-(L - 1), L):
        n = abs(d)
        if n < exact:
            b = n
        else:
            b = exact + int(math.log(n / exact) / math.log(max_distance / exact)
                            * (half - exact))
            b = min(b, half - 1)
        out.append(b + (half if d > 0 else 0))
    table = torch.tensor(out, dtype=torch.long, device=device)
    q = torch.arange(L, device=device)
    return table[q[None, :] - q[:, None] + L - 1]


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def encode(w, cfg, tokens, lengths, rnd=None):
    """Encoder output ``(B, L, d_model)`` in the weights' dtype, zero past
    each length.  ``tokens`` ``(B, L)`` long, ``lengths`` ``(B,)``;
    ``rnd`` rounds every matmul operand first (None: no rounding)."""
    r = rnd or (lambda x: x)

    def mm(a, b):
        return torch.matmul(r(a), r(b))

    B, L = tokens.shape
    H, dk = cfg["num_heads"], cfg["d_kv"]
    eps = cfg["layer_norm_epsilon"]
    keep = torch.arange(L, device=tokens.device)[None, :] < lengths[:, None]
    x = w["embed.weight"][tokens]
    buckets = relative_buckets(L, cfg["relative_attention_num_buckets"],
                               cfg["relative_attention_max_distance"],
                               tokens.device)
    bias = w["block0.attn.relative_attention_bias.weight"][buckets]
    bias = bias.permute(2, 0, 1)[None]                      # (1, H, L, L)
    neg = torch.finfo(x.dtype).min
    for i in range(cfg["num_layers"]):
        p = f"block{i}."
        h = _rms(x, w[p + "ln_attn.weight"], eps)
        q, k, v = (mm(h, w[p + f"attn.{n}.weight"].T)
                   .view(B, L, H, dk).transpose(1, 2) for n in "qkv")
        s = mm(q, k.transpose(-1, -2)) + bias
        s = s.masked_fill(~keep[:, None, None, :], neg)
        o = mm(torch.softmax(s, -1), v)
        x = x + mm(o.transpose(1, 2).reshape(B, L, H * dk),
                   w[p + "attn.o.weight"].T)
        h = _rms(x, w[p + "ln_ff.weight"], eps)
        x = x + mm(torch.relu(mm(h, w[p + "ff.wi.weight"].T)),
                   w[p + "ff.wo.weight"].T)
    x = _rms(x, w["ln_final.weight"], eps)
    return x * keep[..., None].to(x.dtype)
