"""DeepBLAST's training loss and update as plain tensor operations.

* :func:`cross_entropy` — the binary cross entropy of the expected
  alignment against the true alignment over the confident cells (the gap
  mask) inside both lengths, a mean per pair, then a mean over the batch;
  predictions are clamped to ``[3e-8, 1 - 3e-8]`` (``deepblast/
  losses.py``);
* :func:`clip_global` — the gradients scaled to norm ``c`` when their
  global norm is at least ``c``;
* :func:`adamw` — one AdamW update with decoupled weight decay
  (Loshchilov & Hutter 2019): ``p <- p - lr (m^ / (sqrt(v^) + eps) + wd p)``.
"""

from __future__ import annotations

import torch

__all__ = ["cross_entropy", "pair_cross_entropy", "clip_global", "adamw",
           "EPS"]

EPS = 3e-8


def pair_cross_entropy(target, E, x_len, y_len, gmask):
    """Per-pair masked cross entropy ``(B,)``."""
    B, N, M = E.shape
    i = torch.arange(N, device=E.device)[None, :, None]
    j = torch.arange(M, device=E.device)[None, None, :]
    mask = (gmask.bool() & (i < x_len[:, None, None])
            & (j < y_len[:, None, None]))
    p = E.clamp(EPS, 1 - EPS)
    ll = target * torch.log(p) + (1 - target) * torch.log(1 - p)
    ll = torch.where(mask, ll, torch.zeros((), dtype=ll.dtype,
                                           device=ll.device))
    return -ll.sum((1, 2)) / mask.sum((1, 2)).clamp_min(1)


def cross_entropy(target, E, x_len, y_len, gmask):
    """The batch loss: the mean of :func:`pair_cross_entropy`."""
    return pair_cross_entropy(target, E, x_len, y_len, gmask).mean()


def clip_global(grads, c):
    """``grads`` (a dict) scaled to global norm ``c`` when their norm is
    at least ``c``; unchanged for ``c`` None or 0."""
    if not c:
        return grads
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    if norm < c:
        return grads
    return {k: g / norm * c for k, g in grads.items()}


def adamw(params, grads, state, step, lr, betas=(0.9, 0.999), eps=1e-8,
          weight_decay=1e-4):
    """Update ``params`` (a dict of tensors) in place by AdamW at update
    ``step`` (1 for the first); ``state`` holds the moments."""
    b1, b2 = betas
    for k, g in grads.items():
        m, v = state.setdefault(k, (torch.zeros_like(g), torch.zeros_like(g)))
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        state[k] = (m, v)
        mhat = m / (1 - b1 ** step)
        vhat = v / (1 - b2 ** step)
        p = params[k]
        p.sub_(lr * (mhat / (vhat.sqrt() + eps) + weight_decay * p))
