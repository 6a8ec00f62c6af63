"""DeepBLAST's match and gap heads and its alignment potentials (Morton et
al. 2020, ``deepblast/embedding.py`` ``StackedCNN``, ``deepblast/
alignment.py`` ``NeuralAligner``) as plain tensor operations.

A head is a linear layer, then ``layers`` convolutions of width ``k``
with "same" padding (``(k - 1) // 2`` before, the rest after), each
followed by ``relu``; pad positions are zeroed before every convolution,
so the features of a residue do not depend on the padding.  Weights are
``{head}.embed.{weight,bias}`` and ``{head}.conv{i}.{weight,bias}`` for
``head`` in ``match_embedding`` and ``gap_embedding``.

The potentials are ``theta = softplus(zx zy^T)`` (the match head, as
``log(1 + exp(.))`` without a cut-off) and ``A = logsigmoid(gx gy^T)``
(the gap head).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["head", "potentials", "HEADS"]

HEADS = ("match_embedding", "gap_embedding")


def head(w, name, h, lengths, layers, rnd=None):
    """Features ``(B, L, F)`` of head ``name`` over ``h`` ``(B, L, D)``;
    ``rnd`` rounds every matmul and convolution operand first."""
    r = rnd or (lambda x: x)
    L = h.shape[1]
    keep = (torch.arange(L, device=h.device)[None, :]
            < lengths[:, None])[..., None].to(h.dtype)
    h = F.linear(r(h), r(w[f"{name}.embed.weight"]), w[f"{name}.embed.bias"])
    for i in range(layers):
        h = h * keep
        wt, b = w[f"{name}.conv{i}.weight"], w[f"{name}.conv{i}.bias"]
        k = wt.shape[-1]
        x = F.pad(h.transpose(1, 2), ((k - 1) // 2, k - 1 - (k - 1) // 2))
        h = torch.relu(F.conv1d(r(x), r(wt), b).transpose(1, 2))
    return h


def potentials(w, hx, hy, x_len, y_len, layers, rnd=None):
    """``(theta, A)`` ``(B, N, M)`` of LM features ``hx``, ``hy``."""
    r = rnd or (lambda x: x)
    zx, gx = (head(w, n, hx, x_len, layers, rnd) for n in HEADS)
    zy, gy = (head(w, n, hy, y_len, layers, rnd) for n in HEADS)
    s = torch.matmul(r(zx), r(zy).transpose(1, 2))
    theta = torch.logaddexp(s, torch.zeros((), dtype=s.dtype, device=s.device))
    A = F.logsigmoid(torch.matmul(r(gx), r(gy).transpose(1, 2)))
    return theta, A
