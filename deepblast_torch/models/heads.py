"""Match/gap embedding heads (``deepblast_tpu/models/heads.py``).

All heads map padded LM embeddings ``(B, L, D)`` to head features
``(B, L, F)`` — the JAX package's channels-last layout at every public
function, so both packages compare like with like; the convolutions
transpose to PyTorch's ``(B, C, L)`` internally.

:class:`StackedCNN` takes ``lengths`` and zeroes pad positions before
*every* convolution, so features at true positions do not depend on pad
width or pad content (``heads.py:42-67``).  Submodule names follow the flax
parameter names (``embed``, ``conv0``, ...) so ``models/convert.py`` maps
flax trees by name.  The RNN head is not ported yet.

Dropout (flax ``nn.Dropout``: keep with probability ``1 - rate``, scale
kept values by ``1 / (1 - rate)``) draws its mask from the
``torch.Generator`` the caller passes, and acts only in ``train()`` mode.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["StackedCNN", "LinearHead", "build_head", "dropout"]


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


class LinearHead(nn.Module):
    """Single linear head (``heads.py:95-104``); position-local, so
    ``lengths`` is accepted and ignored."""

    def __init__(self, in_features, features, device=None, dtype=None):
        super().__init__()
        self.linear = nn.Linear(in_features, features, device=device,
                                dtype=dtype)

    def forward(self, x, lengths=None, generator=None):
        return self.linear(x)


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
        raise NotImplementedError("the RNN head is not ported yet")
    raise ValueError(f"layer type {layer_type!r} not supported")
