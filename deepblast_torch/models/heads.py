"""Match/gap embedding heads (``deepblast_tpu/models/heads.py``).

All heads map padded LM embeddings ``(B, L, D)`` to head features
``(B, L, F)`` — the JAX package's channels-last layout at every public
function, so both packages compare like with like; the convolutions
transpose to PyTorch's ``(B, C, L)`` internally.

:class:`StackedCNN` takes ``lengths`` and zeroes pad positions before
*every* convolution, so features at true positions do not depend on pad
width or pad content (``heads.py:42-67``).  Submodule names follow the flax
parameter names (``embed``, ``conv0``, ``fwd0``, ...) so
``models/convert.py`` maps flax trees by name.

:class:`StackedRNN` runs each ``torch.nn.LSTM`` (or GRU; cuDNN on the card,
with TF32 off where the trainer or a loader places the model there:
``models.exact_cuda_math``) over the whole padded batch, as flax's
``nn.RNN`` runs its ``lax.scan``: the forward direction reads each
sequence from its start, so its outputs at true positions never see
padding; the reverse direction flips each sequence within its length
(:func:`flip_sequences`, a gather on the device, flax's
``flip_sequences``), runs, and flips back.  No packed sequences: packing
needs the lengths on the host, a wait for the card in every step.
Outputs past a sequence's length are computed and are garbage, as in JAX.
flax's cells carry one bias a gate where torch's carry two
(:func:`flax_biases`): the other is held at zero, so training moves the
same parameters as the JAX package's.

Dropout (flax ``nn.Dropout``: keep with probability ``1 - rate``, scale
kept values by ``1 / (1 - rate)``) draws its mask from the
``torch.Generator`` the caller passes, and acts only in ``train()`` mode.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["StackedCNN", "StackedRNN", "LinearHead", "LMEmbed",
           "EmbedLinear", "build_head", "dropout", "flip_sequences",
           "recur", "flax_biases", "FlaxGRU"]


def _length_mask(x, lengths):
    """``(B, L, 1)`` mask of true positions in ``x``'s dtype, or None."""
    if lengths is None:
        return None
    L = x.shape[-2]
    lengths = torch.as_tensor(lengths, device=x.device)
    pos = torch.arange(L, device=x.device)
    return (pos[None, :] < lengths[:, None])[..., None].to(x.dtype)


def dropout(x, rate, generator=None):
    """flax's dropout with a mask drawn from ``generator`` (``None``: the
    global generator of ``x``'s device)."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class StackedCNN(nn.Module):
    """Linear embed -> ``layers`` x [Conv1d(k, same) + ReLU] -> dropout
    (``heads.py:42-67``)."""

    def __init__(self, in_features, features, layers=2, k_size=5,
                 dropout=0.0, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.layers = layers
        self.embed = nn.Linear(in_features, in_features, **kw)
        for i in range(layers):
            self.add_module(f"conv{i}", nn.Conv1d(
                in_features if i == 0 else features, features, k_size,
                padding="same", **kw))
        self.rate = dropout

    def forward(self, x, lengths=None, generator=None):
        mask = _length_mask(x, lengths)
        h = self.embed(x)
        for i in range(self.layers):
            if mask is not None:
                h = h * mask
            conv = getattr(self, f"conv{i}")
            h = torch.relu(conv(h.transpose(1, 2)).transpose(1, 2))
        return dropout(h, self.rate, generator) if self.training else h


def flip_sequences(x, lengths):
    """``x (B, L, ...)`` with each sequence's first ``lengths[b]`` positions
    reversed in place and its padding reversed after them (flax's
    ``flip_sequences``: position ``t`` takes ``(L - 1 - t + length) % L``);
    its own inverse.  ``lengths`` None reverses the whole axis."""
    if lengths is None:
        return x.flip(1)
    L = x.shape[1]
    lengths = torch.as_tensor(lengths, device=x.device).long()
    t = torch.arange(L, device=x.device)
    idx = (L - 1 - t[None, :] + lengths[:, None]) % L
    idx = idx.view(idx.shape + (1,) * (x.dim() - 2)).expand_as(x)
    return torch.gather(x, 1, idx)


class FlaxGRU(nn.GRU):
    """A one-layer ``nn.GRU`` with flax's ``GRUCell`` biases: none on the
    hidden side of the reset and update gates, the first two thirds of
    torch's ``bias_hh_l0`` (its last third is flax's ``hn`` bias).  Each
    forward runs with those entries replaced by zeros, so they take no
    part and get no gradient; being in ``forward``, this survives a deep
    copy and a pickle, where a gradient hook would not."""

    def forward(self, x, hx=None):
        keep = 2 * self.hidden_size
        flat = self._flat_weights
        i = self._flat_weights_names.index("bias_hh_l0")
        b = flat[i]
        self._flat_weights = flat[:i] + [torch.cat(
            [torch.zeros_like(b[:keep]), b[keep:]])] + flat[i + 1:]
        try:
            return super().forward(x, hx)
        finally:
            self._flat_weights = flat


def flax_biases(rnn):
    """``rnn`` (a one-layer ``nn.LSTM`` or :class:`FlaxGRU`) with the
    biases of flax's cell, so training moves what the JAX package trains:
    ``OptimizedLSTMCell`` has one bias a gate (torch's ``bias_hh_l0``), so
    the LSTM's ``bias_ih_l0`` is zeroed and frozen (``requires_grad`` off:
    no gradient, no optimizer state, out of the gradient norm).  The GRU's
    unused biases are zeroed here and left out of every forward by
    :class:`FlaxGRU`."""
    if isinstance(rnn, nn.LSTM):
        with torch.no_grad():
            rnn.bias_ih_l0.zero_()
        rnn.bias_ih_l0.requires_grad_(False)
    else:
        with torch.no_grad():
            rnn.bias_hh_l0[:2 * rnn.hidden_size].zero_()
    rnn.flatten_parameters()    # one cuDNN weight buffer (no-op on the CPU)
    return rnn


def recur(rnn, x, lengths=None, reverse=False):
    """A one-layer ``batch_first`` LSTM / GRU over ``x (B, L, F)`` from a
    zero state, as flax's ``nn.RNN(cell, reverse=reverse, keep_order=True)``
    with ``seq_lengths=lengths``; the outputs ``(B, L, H)``."""
    if reverse:
        x = flip_sequences(x, lengths)
    out, _ = rnn(x)
    return flip_sequences(out, lengths) if reverse else out


class StackedRNN(nn.Module):
    """Linear embed -> ``layers`` x [LSTM or GRU both ways (``fwd{i}``,
    ``bwd{i}``), concatenated] -> dropout -> ``proj`` (``heads.py:70-92``).
    ``rnn_type`` is ``"lstm"`` (what ``build_head`` builds) or ``"gru"``."""

    def __init__(self, in_features, hidden, features, layers=2, dropout=0.0,
                 rnn_type="lstm", device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        cell = {"lstm": nn.LSTM, "gru": FlaxGRU}[rnn_type]
        self.layers = layers
        self.embed = nn.Linear(in_features, in_features, **kw)
        width = in_features
        for i in range(layers):
            for d in ("fwd", "bwd"):
                self.add_module(f"{d}{i}", flax_biases(cell(
                    width, hidden, batch_first=True, **kw)))
            width = 2 * hidden
        self.rate = dropout
        self.proj = nn.Linear(width, features, **kw)

    def forward(self, x, lengths=None, generator=None):
        h = self.embed(x)
        for i in range(self.layers):
            hf = recur(getattr(self, f"fwd{i}"), h, lengths)
            hb = recur(getattr(self, f"bwd{i}"), h, lengths, reverse=True)
            h = torch.cat([hf, hb], dim=-1)
        if self.training:
            h = dropout(h, self.rate, generator)
        return self.proj(h)


class LinearHead(nn.Module):
    """Single linear head (``heads.py:95-104``); position-local, so
    ``lengths`` is accepted and ignored."""

    def __init__(self, in_features, features, device=None, dtype=None):
        super().__init__()
        self.linear = nn.Linear(in_features, features, device=device,
                                dtype=dtype)

    def forward(self, x, lengths=None, generator=None):
        return self.linear(x)


class LMEmbed(nn.Module):
    """``relu(embed(tokens) + proj(lm_states))`` (``heads.py:107-119``);
    ``lm_dim`` is the width of ``lm_states``."""

    def __init__(self, nin, nout, lm_dim, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.Embedding(nin, nout, **kw)
        self.proj = nn.Linear(lm_dim, nout, **kw)

    def forward(self, tokens, lm_states):
        return torch.relu(self.embed(tokens) + self.proj(lm_states))


class EmbedLinear(nn.Module):
    """A token embedding, or with ``use_lm`` an :class:`LMEmbed` of width
    ``nhidden`` followed by a linear projection (``heads.py:122-138``)."""

    def __init__(self, nin, nhidden, nout, use_lm=False, lm_dim=None,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.use_lm = use_lm
        if use_lm:
            self.lmembed = LMEmbed(nin, nhidden, lm_dim, **kw)
            self.proj = nn.Linear(nhidden, nout, **kw)
        else:
            self.embed = nn.Embedding(nin, nout, **kw)

    def forward(self, tokens, lm_states=None):
        if self.use_lm:
            return self.proj(self.lmembed(tokens, lm_states))
        return self.embed(tokens)


def build_head(layer_type: str, *, embedding_dim: int, hidden_dim: int,
               layers: int, k_size: int = 5, dropout: float = 0.0,
               device=None, dtype=None):
    """Head selection of ``heads.py:141-154``."""
    kw = dict(device=device, dtype=dtype)
    if layers <= 1:
        return LinearHead(embedding_dim, hidden_dim, **kw)
    if layer_type == "cnn":
        return StackedCNN(embedding_dim, hidden_dim, layers=layers,
                          k_size=k_size, dropout=dropout, **kw)
    if layer_type == "rnn":
        return StackedRNN(embedding_dim, hidden_dim, hidden_dim,
                          layers=layers, dropout=dropout, **kw)
    raise ValueError(f"layer type {layer_type!r} not supported")
