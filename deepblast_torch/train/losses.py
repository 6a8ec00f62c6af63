"""Alignment losses (``deepblast_tpu/train/losses.py``): each a single
masked reduction over the padded ``(B, N, M)`` batch, mean per pair, then
mean over the batch."""

from __future__ import annotations

import torch

__all__ = [
    "EPS",
    "matrix_cross_entropy",
    "soft_alignment_loss",
    "soft_path_loss",
    "get_loss",
]

#: Smallest clamp the reference found numerically safe.
EPS = 3e-8


def _pair_mask(G, x_len, y_len):
    B, N, M = G.shape
    i = torch.arange(N, device=G.device)[None, :, None]
    j = torch.arange(M, device=G.device)[None, None, :]
    inside = (i < x_len[:, None, None]) & (j < y_len[:, None, None])
    return G.bool() & inside


def matrix_cross_entropy(Ytrue, Ypred, x_len, y_len, G):
    """Masked binary cross entropy, mean per pair then mean over batch."""
    mask = _pair_mask(G, x_len, y_len)
    Yp = torch.clamp(Ypred, EPS, 1 - EPS)
    ll = Ytrue * torch.log(Yp) + (1 - Ytrue) * torch.log(1 - Yp)
    ll = torch.where(mask, ll, torch.zeros((), dtype=ll.dtype,
                                           device=ll.device))
    count = torch.clamp_min(mask.sum(dim=(1, 2)), 1)
    per_pair = -ll.sum(dim=(1, 2)) / count
    return per_pair.mean()


def soft_alignment_loss(Ytrue, Ypred, x_len, y_len, G):
    """Masked Frobenius norm of ``Ytrue - Ypred`` per pair."""
    mask = _pair_mask(G, x_len, y_len)
    d = Ytrue - Ypred
    d = torch.where(mask, d, torch.zeros((), dtype=d.dtype, device=d.device))
    per_pair = torch.sqrt(torch.sum(d * d, dim=(1, 2)) + 1e-12)
    return per_pair.mean()


def soft_path_loss(P, Ypred, x_len, y_len, G):
    """Masked Frobenius norm of ``P * Ypred`` per pair."""
    mask = _pair_mask(G, x_len, y_len)
    d = P * Ypred
    d = torch.where(mask, d, torch.zeros((), dtype=d.dtype, device=d.device))
    per_pair = torch.sqrt(torch.sum(d * d, dim=(1, 2)) + 1e-12)
    return per_pair.mean()


_LOSSES = {
    "cross_entropy": matrix_cross_entropy,
    "sse": soft_alignment_loss,
    "path": soft_path_loss,
}


def get_loss(name):
    if name not in _LOSSES:
        raise ValueError(f"`{name}` is not implemented.")
    return _LOSSES[name]
