"""Protein language models (``deepblast_tpu/models/lm.py``): the tied
BiLM, the ProtT5 encoder and a plain token embedding, and their weights
from torch checkpoints.

:class:`BiLM` (``lm.py:36-110``) is the Bepler et al. 2019 tied
bidirectional LSTM: one ``torch.nn.LSTM`` a layer (``lstm{i}``, flax's
``nn.RNN(OptimizedLSTMCell)``) runs both directions over shifted inputs,
so position ``i``'s features never see token ``i``.  The reverse direction
flips each sequence within its length (``heads.flip_sequences``), so the
outputs at true positions equal JAX's whatever the padding.  It computes
in float32 (cuDNN on the card, TF32 off where the trainer or a loader
places it there: ``models.exact_cuda_math``).
:func:`convert_bepler_bilm` / :func:`load_bilm` read the reference's
``lstm2x.pt`` layout and :func:`convert_hf_t5_encoder` /
:func:`load_prot_t5` a HuggingFace ``T5EncoderModel`` state dict, both
through the JAX package's flax trees (``models/convert.py``), so the port
runs the weights exactly as the JAX package does (the Bepler LSTM's two
biases summed into one, as flax keeps one).

:class:`T5Encoder` keeps the JAX package's T5 exactly: no ``1/sqrt(d_kv)``
scaling of the scores (``lm.py:249``), the relative-position bias table
only in block 0 and shared by every block (``lm.py:252-263``), pad keys
masked with ``finfo(float32).min`` (``lm.py:264-266``), attention scores,
their softmax and the RMSNorm variance taken in float32 (``lm.py:214``,
``:250``), and the output zero at pad positions (``lm.py:333``).

Packed rows: where the mask leaves positions padded, the residual stream
is ``(T, d_model)`` over the ``T`` valid positions (:class:`_Packing`),
so the embedding, the RMSNorms, the q/k/v/o projections, the FFN and the
residual adds run on valid rows only; each block scatters q, k and v into
zero-filled ``(B, L, H, d_kv)`` for the attention core, which is the
padded computation unchanged, and gathers its output back before ``o``.
Every valid position computes the same mathematics (a masked key's
probability is exactly 0), so only a GEMM's rounding can differ with its
row count.  A mask with every position valid takes the padded path
itself, with no index operation, and so does a call that gives no
count of valid positions (``rows``): the count comes from the host's
lengths, never from the mask.  The counters ``lm.rows`` (rows the
token-wise layers ran on) and ``lm.rows_padded`` (``B * L``) count each
call while recording (``utils/profiling.py``).
Submodule names follow the flax parameter names (``block0.attn.q``, ...)
so ``models/convert.py`` maps flax trees by name.

Compute dtype (``T5Config.dtype``, the JAX ``T5Config.dtype`` that the
trainer's ``--precision`` sets, ``trainer.py:158``, ``:250-253``): the
parameters stay float32 and each layer follows flax's rules for a module
built with ``dtype=`` (``lm.py:193-330``), written out rather than left to
``torch.autocast``, whose cast list differs.  ``nn.Embed`` returns the
table cast to the dtype; every ``Dense`` casts its input and its kernel
and returns the dtype; the attention scores are float32 products of the
dtype's values (``preferred_element_type``: a product of two bf16 or fp16
values is exact in float32, so the operands are widened and multiplied in
float32), the mask value float32's ``min``, the softmax float32, the
probabilities cast to the dtype; the relative-position table stays
float32.  ``RMSNorm`` returns ``(x * rsqrt).astype(x.dtype) * scale`` with
a float32 scale, so float32, and the residual stream keeps the dtype its
adds give it.  At ``"float32"`` every cast is the identity.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from deepblast_torch.models import exact_cuda_math
from deepblast_torch.models.heads import flax_biases, flip_sequences
from deepblast_torch.utils.profiling import count

__all__ = ["BiLM", "convert_bepler_bilm", "load_bilm", "TokenEmbed",
           "T5Config", "RMSNorm", "relative_position_bucket", "T5Attention",
           "T5FF", "T5Block", "T5Encoder", "convert_hf_t5_encoder",
           "load_prot_t5", "pretrained_language_models"]


class BiLM(nn.Module):
    """Tied bidirectional stacked-LSTM language model."""

    def __init__(self, nin=22, nout=21, embedding_dim=21, hidden_dim=1024,
                 num_layers=2, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.nin, self.nout = nin, nout
        self.embedding_dim, self.hidden_dim = embedding_dim, hidden_dim
        self.num_layers = num_layers
        self.embed = nn.Embedding(nin, embedding_dim, **kw)
        for i in range(num_layers):
            self.add_module(f"lstm{i}", flax_biases(nn.LSTM(
                embedding_dim if i == 0 else hidden_dim, hidden_dim,
                batch_first=True, **kw)))
        self.linear = nn.Linear(hidden_dim, nout, **kw)

    @property
    def hidden_size(self):
        return 2 * self.num_layers * self.hidden_dim

    def _directional(self, inputs, lengths, reverse):
        """Each layer's outputs over ``inputs``; ``reverse`` flips the
        sequences within their lengths once and each output back (flax
        flips around every layer: the flip is its own inverse)."""
        h = flip_sequences(inputs, lengths) if reverse else inputs
        outs = []
        for i in range(self.num_layers):
            h, _ = getattr(self, f"lstm{i}")(h)
            outs.append(h)
        return [flip_sequences(o, lengths) for o in outs] if reverse \
            else outs

    def _split_inputs(self, tokens, lengths):
        """The shifted streams: forward ``[flank, x_1 .. x_{L-1}]``,
        reverse ``[x_2 .. x_L, 0]`` with the flank at ``lengths - 1``; the
        flank (start/stop) token is embedding id ``nin - 1``."""
        B, L = tokens.shape
        e = self.embed(tokens)
        flank = self.embed.weight[self.nin - 1].expand(B, 1, -1)
        fwd_in = torch.cat([flank, e[:, :-1]], dim=1)
        shifted = torch.cat([e[:, 1:], torch.zeros_like(e[:, :1])], dim=1)
        pos = torch.arange(L, device=tokens.device)
        is_last = (pos[None, :] == (lengths[:, None] - 1))[..., None]
        return fwd_in, torch.where(is_last, flank, shifted)

    def _lengths(self, tokens, lengths):
        if lengths is None:
            return torch.full(tokens.shape[:1], tokens.shape[1],
                              device=tokens.device)
        return torch.as_tensor(lengths, device=tokens.device)

    def encode(self, tokens, lengths=None):
        """Context embeddings ``(B, L, 2 * num_layers * hidden_dim)``:
        ``[fwd_0, rvs_0, fwd_1, rvs_1, ...]``."""
        lengths = self._lengths(tokens, lengths)
        fwd_in, rvs_in = self._split_inputs(tokens, lengths)
        h_fwd = self._directional(fwd_in, lengths, reverse=False)
        h_rvs = self._directional(rvs_in, lengths, reverse=True)
        return torch.cat([h for pair in zip(h_fwd, h_rvs) for h in pair],
                         dim=-1)

    def forward(self, tokens, lengths=None):
        """Next/previous-token log probabilities ``(B, L, nout)``."""
        lengths = self._lengths(tokens, lengths)
        fwd_in, rvs_in = self._split_inputs(tokens, lengths)
        h_fwd = self._directional(fwd_in, lengths, reverse=False)[-1]
        h_rvs = self._directional(rvs_in, lengths, reverse=True)[-1]
        return torch.log_softmax(self.linear(h_fwd) + self.linear(h_rvs),
                                 dim=-1)


def convert_bepler_bilm(state_dict, num_layers=2):
    """A :class:`BiLM` ``state_dict`` from a Bepler tied-BiLM torch state
    dict (the ``lstm2x.pt`` layout: ``embed.weight``,
    ``rnn.{i}.{weight,bias}_{ih,hh}_l0``, ``linear.{weight,bias}``;
    ``lm.py:113-146``), through the JAX package's flax tree: the same
    weights, the two LSTM biases summed into ``bias_hh_l0`` and
    ``bias_ih_l0`` zero, as the JAX BiLM computes."""
    from deepblast_torch.models.convert import bepler_bilm_tree, \
        params_from_jax
    return params_from_jax(bepler_bilm_tree(state_dict, num_layers))


def _bilm_geometry(sd):
    """``(nin, nout, embedding_dim, hidden_dim, num_layers)`` of a Bepler
    state dict."""
    nin, emb = tuple(sd["embed.weight"].shape)
    nl = len({k.split(".")[1] for k in sd if k.startswith("rnn.")})
    return (int(nin), int(sd["linear.weight"].shape[0]), int(emb),
            int(sd["rnn.0.weight_hh_l0"].shape[1]), nl)


def load_bilm(path, **kw):
    """``(BiLM, state_dict)`` of a Bepler tied-BiLM checkpoint file
    (``lm.py:149-162``), read with ``weights_only=True``; a whole-module
    pickle (when its classes are allow-listed) is unwrapped.  ``kw`` goes
    to :class:`BiLM` (``device``, ``dtype``); a CUDA ``device`` sets
    ``exact_cuda_math``'s flags."""
    if torch.device(kw.get("device") or "cpu").type == "cuda":
        exact_cuda_math()
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):           # whole-module pickles
        sd = sd.state_dict()
    nin, nout, emb, hidden, nl = _bilm_geometry(sd)
    model = BiLM(nin=nin, nout=nout, embedding_dim=emb, hidden_dim=hidden,
                 num_layers=nl, **kw)
    return model, convert_bepler_bilm(sd, num_layers=nl)


class TokenEmbed(nn.Module):
    """Plain learned token embedding — the LM-free minimal path."""

    def __init__(self, vocab, dim, device=None, dtype=None):
        super().__init__()
        self.embed = nn.Embedding(vocab, dim, device=device, dtype=dtype)

    def forward(self, tokens, lengths=None):
        return self.embed(tokens)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 128
    d_model: int = 1024
    d_kv: int = 128
    d_ff: int = 16384
    num_layers: int = 24
    num_heads: int = 32
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"   # "relu" | "gated-gelu"
    dtype: str = "float32"            # compute dtype: float32 | bfloat16
    #                                   | float16 (parameters stay float32)

    @property
    def compute_dtype(self):
        return getattr(torch, self.dtype)

    @classmethod
    def prot_t5_xl(cls, **kw):
        """Rostlab/prot_t5_xl_uniref50 encoder geometry."""
        return cls(vocab_size=128, d_model=1024, d_kv=128, d_ff=16384,
                   num_layers=24, num_heads=32, **kw)

    @classmethod
    def tiny(cls, **kw):
        """Small config for tests."""
        return cls(vocab_size=32, d_model=32, d_kv=8, d_ff=64,
                   num_layers=2, num_heads=4, **kw)


class RMSNorm(nn.Module):
    def __init__(self, dim, eps=1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device,
                                              dtype=dtype))

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


def _dense(linear, x, dtype):
    """flax ``nn.Dense(dtype=dtype, use_bias=False)``: input and kernel
    cast to ``dtype``, the product in ``dtype``."""
    return F.linear(x.to(dtype), linear.weight.to(dtype))


def relative_position_bucket(rel_pos, num_buckets=32, max_distance=128):
    """T5's bidirectional relative-position bucketing (in float32, as the
    JAX package computes it)."""
    num_buckets //= 2
    ret = (rel_pos > 0).long() * num_buckets
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).long()
    val_if_large = torch.clamp_max(val_if_large, num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class _Packing:
    """The valid positions of a ``(B, L)`` mask as the rows of a packed
    ``(T, ...)`` stream, in the mask's row-major order; ``T`` (``rows``)
    is the mask's count of valid positions, known on the host, so nothing
    here reads the device."""

    def __init__(self, mask, rows):
        self.shape = tuple(mask.shape)
        # the flat index of the t-th valid position: the first place the
        # running count of valid positions reaches t + 1
        seen = mask.reshape(-1).cumsum(0)
        self.index = torch.searchsorted(
            seen, torch.arange(1, rows + 1, device=mask.device))

    def pack(self, t):
        """``(B, L, ...)`` -> the valid rows ``(T, ...)``."""
        return t.reshape((-1,) + t.shape[2:]).index_select(0, self.index)

    def unpack(self, t):
        """The valid rows ``(T, ...)`` -> ``(B, L, ...)``, zero at pad
        positions."""
        B, L = self.shape
        out = t.new_zeros((B * L,) + t.shape[1:])
        return out.index_copy_(0, self.index, t).view((B, L) + t.shape[1:])


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias=False, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, **kw)
        self.k = nn.Linear(cfg.d_model, inner, **kw)
        self.v = nn.Linear(cfg.d_model, inner, **kw)
        self.o = nn.Linear(inner, cfg.d_model, **kw)
        self.relative_attention_bias = nn.Embedding(
            cfg.relative_attention_num_buckets, cfg.num_heads,
            device=device, dtype=dtype) if has_relative_bias else None

    def position_bias(self, L, device):
        """``(1, H, L, L)`` bias from the bucketed key-minus-query offsets."""
        pos = torch.arange(L, device=device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None],
            self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)[None]

    def forward(self, x, mask, position_bias=None, packing=None):
        """``x`` is ``(B, L, d_model)``, or with ``packing`` the packed
        valid rows ``(T, d_model)``, and so is the output."""
        cfg = self.cfg
        dt = cfg.compute_dtype
        B, L = x.shape[:2] if packing is None else packing.shape
        shape = (B, L, cfg.num_heads, cfg.d_kv)

        def heads(linear):
            h = _dense(linear, x, dt)
            return (h if packing is None else packing.unpack(h)).view(shape)
        q, k, v = heads(self.q), heads(self.k), heads(self.v)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        if self.relative_attention_bias is not None:
            position_bias = self.position_bias(L, x.device)
        if position_bias is not None:
            scores = scores + position_bias
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :],
                                        torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, L, -1)
        if packing is not None:
            out = packing.pack(out)
        return _dense(self.o, out, dt), position_bias


class T5FF(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=False, device=device, dtype=dtype)
        self.dtype = cfg.compute_dtype
        self.gated = cfg.feed_forward_proj == "gated-gelu"
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, **kw)

    def forward(self, x):
        dt = self.dtype
        if self.gated:
            h = F.gelu(_dense(self.wi_0, x, dt), approximate="tanh") \
                * _dense(self.wi_1, x, dt)
        else:
            h = torch.relu(_dense(self.wi, x, dt))
        return _dense(self.wo, h, dt)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias=False, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ln_attn = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, **kw)
        self.attn = T5Attention(cfg, has_relative_bias, **kw)
        self.ln_ff = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, **kw)
        self.ff = T5FF(cfg, **kw)

    def forward(self, x, mask, position_bias=None, packing=None):
        attn, position_bias = self.attn(self.ln_attn(x), mask, position_bias,
                                        packing)
        x = x + attn
        x = x + self.ff(self.ln_ff(x))
        return x, position_bias


class T5Encoder(nn.Module):
    """ProtT5-class encoder producing residue embeddings
    ``(B, L, d_model)``, zero at pad positions."""

    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, **kw)
        for i in range(cfg.num_layers):
            self.add_module(f"block{i}",
                            T5Block(cfg, has_relative_bias=(i == 0), **kw))
        self.ln_final = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, **kw)

    def forward(self, tokens, mask=None, rows=None):
        """Embeddings of ``tokens`` ``(B, L)`` under ``mask`` (every
        position valid if None).  ``rows``: the mask's count of valid
        positions, as the caller holds it on the host; without it every
        position runs, since counting the mask would wait for a card."""
        padded = tokens.numel()
        if mask is None:
            mask = torch.ones(tokens.shape, dtype=torch.bool,
                              device=tokens.device)
        mask = mask.bool()
        if rows is None:
            rows = padded
        count("lm.rows", rows)
        count("lm.rows_padded", padded)
        packing = _Packing(mask, rows) if rows < padded else None
        if packing is not None:
            tokens = packing.pack(tokens)
        x = self.embed(tokens).to(self.cfg.compute_dtype)
        position_bias = None
        for i in range(self.cfg.num_layers):
            x, position_bias = getattr(self, f"block{i}")(
                x, mask, position_bias, packing)
        x = self.ln_final(x)
        if packing is not None:
            return packing.unpack(x)
        return x * mask[..., None].to(x.dtype)


def convert_hf_t5_encoder(state_dict, cfg: T5Config):
    """A :class:`T5Encoder` ``state_dict`` from a HuggingFace
    ``T5EncoderModel`` state dict (``lm.py:336-374``), through the JAX
    package's flax tree: ``shared.weight`` -> ``embed.weight``,
    ``encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}`` ->
    ``block{i}.attn.*``, the relative-position bias of block 0, the two
    layer norms, ``DenseReluDense.{wi | wi_0, wi_1}, wo`` -> ``ff.*`` and
    ``encoder.final_layer_norm`` -> ``ln_final``."""
    from deepblast_torch.models.convert import hf_t5_encoder_tree, \
        params_from_jax
    return params_from_jax(hf_t5_encoder_tree(state_dict, cfg))


def load_prot_t5(path, cfg: T5Config = None):
    """``(T5Encoder, state_dict)`` of a local HF checkpoint directory (its
    ``pytorch_model.bin``) or file, read with ``weights_only=True``
    (``lm.py:377-387``).  ``cfg`` defaults to the geometry the state dict
    has (``convert.infer_t5_config``: ProtT5-XL for Rostlab's weights,
    where the JAX package always assumes ProtT5-XL), float32 compute."""
    from deepblast_torch.models.convert import infer_t5_config
    f = os.path.join(path, "pytorch_model.bin") if os.path.isdir(path) \
        else path
    sd = torch.load(f, map_location="cpu", weights_only=True)
    cfg = cfg or infer_t5_config(sd)
    return T5Encoder(cfg), convert_hf_t5_encoder(sd, cfg)


#: ``lm.py:391-394``
pretrained_language_models = {
    "bilstm": BiLM,
    "prot_t5_xl": T5Config.prot_t5_xl,
}
