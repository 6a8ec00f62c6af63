"""DeepBLAST's model (ProtT5 encoder, CNN heads, potentials, soft NW) as a
plain reference: features, expected alignments and a training step,
computed in pieces so that they fit beside nothing else on the card.

``precision`` names how the reference computes: ``"float64"``,
``"float32"``, or ``"tf32"``: float32 whose forward matmul and
convolution operands are first rounded to TF32 (10 stored mantissa bits,
to nearest even), the products then exact and summed in float32, as the
tensor cores do (the backward's products stay float32); it is the
control of a configuration that states float32 with TF32 off, and runs
alike on any device.  ``dp_dtype`` is the soft NW's
type (``None``: the same).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference import heads as ref_heads
from portbench.reference import nw, t5, tmalign
from portbench.reference import train as ref_train

__all__ = ["round_tf32", "precision", "features", "pair_batch", "expected_alignments",
           "train_steps"]


def round_tf32(x):
    """float32 ``x`` rounded to TF32's 10 mantissa bits, ties to even;
    the gradient passes through unrounded."""
    i = x.detach().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return x + (i.view(torch.float32) - x.detach())


@contextlib.contextmanager
def precision(name):
    """``(dtype, operand rounding)`` of ``name``, with the card's own TF32
    off throughout (the rounding, where there is one, is explicit)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield (torch.float64 if name == "float64" else torch.float32,
               round_tf32 if name == "tf32" else None)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def features(w, lm_cfg, seqs, rnd=None, block_tokens=16384):
    """Encoder features ``(L, d_model)`` of each sequence (no gradient),
    in blocks of about ``block_tokens`` padded residues."""
    order = sorted(range(len(seqs)), key=lambda k: len(seqs[k]))
    device = w["embed.weight"].device
    out = [None] * len(seqs)
    k = 0
    with torch.no_grad():
        while k < len(order):
            L = len(seqs[order[k]])
            n = 1
            while k + n < len(order) and \
                    (n + 1) * len(seqs[order[k + n]]) <= block_tokens:
                n += 1
            part = order[k:k + n]
            L = max(len(seqs[q]) for q in part)
            tok = torch.zeros((n, L), dtype=torch.long, device=device)
            for r, q in enumerate(part):
                tok[r, :len(seqs[q])] = torch.as_tensor(tmalign.tokens(seqs[q]))
            lens = torch.tensor([len(seqs[q]) for q in part], device=device)
            h = t5.encode(w, lm_cfg, tok, lens, rnd)
            for r, q in enumerate(part):
                out[q] = h[r, :len(seqs[q])]
            k += n
    return out


def _pad(feats):
    L = max(f.shape[0] for f in feats)
    out = feats[0].new_zeros((len(feats), L, feats[0].shape[1]))
    for r, f in enumerate(feats):
        out[r, :f.shape[0]] = f
    return out


def pair_batch(rows, fx, fy, device, dtype):
    """Padded features, lengths, targets and gap masks of TM-align rows
    ``(.., x, y, states)`` whose features are ``fx``, ``fy``."""
    x_len = torch.tensor([len(r[5]) for r in rows], device=device)
    y_len = torch.tensor([len(r[6]) for r in rows], device=device)
    N, M = int(x_len.max()), int(y_len.max())
    target = np.zeros((len(rows), N, M), np.float32)
    gmask = np.zeros((len(rows), N, M), bool)
    for b, r in enumerate(rows):
        t, g = tmalign.alignment(len(r[5]), len(r[6]), r[7])
        target[b, :t.shape[0], :t.shape[1]] = t
        gmask[b, :g.shape[0], :g.shape[1]] = g
    return dict(hx=_pad(fx).to(dtype), hy=_pad(fy).to(dtype), x_len=x_len,
                y_len=y_len,
                target=torch.as_tensor(target, device=device).to(dtype),
                gmask=torch.as_tensor(gmask, device=device))


def expected_alignments(w, cfg, rows, precision_name="float64",
                        dp_dtype=None):
    """Each row's expected alignment ``(n, m)`` as a NumPy array."""
    device = w["embed.weight"].device
    with precision(precision_name) as (dt, rnd):
        wd = {k: v.to(dt) for k, v in w.items()}
        fx = features(wd, cfg["lm"], [r[5] for r in rows], rnd)
        fy = features(wd, cfg["lm"], [r[6] for r in rows], rnd)
        out = []
        with torch.no_grad():
            for k, r in enumerate(rows):
                b = pair_batch([r], [fx[k]], [fy[k]], device, dt)
                th, A = ref_heads.potentials(wd, b["hx"], b["hy"], b["x_len"],
                                             b["y_len"], cfg["heads"]["layers"],
                                             rnd)
                E = nw.expected(th.to(dp_dtype or dt), A.to(dp_dtype or dt),
                                b["x_len"], b["y_len"])
                out.append(E[0].double().cpu().numpy())
    return out


def train_steps(w, cfg, steps, precision_name="float64", dp_dtype=None):
    """DeepBLAST's training steps from weights ``w`` on ``steps`` (a list of
    row lists): the frozen LM's features, the heads, the potentials, the
    expected alignment, the masked cross entropy, the global-norm clip
    and AdamW.  Returns ``(losses, first_grads, params)``: each step's
    loss, the first step's clipped gradients and the heads' weights after
    the last step, as dicts of float64 tensors."""
    t = cfg["training"]
    layers = cfg["heads"]["layers"]
    device = w["embed.weight"].device
    head_names = [k for k in w if k.split(".")[0] in ref_heads.HEADS]
    losses, first = [], None
    with precision(precision_name) as (dt, rnd):
        lm_w = {k: v.to(dt) for k, v in w.items() if k not in head_names}
        params = {k: w[k].to(dt).clone() for k in head_names}
        state = {}
        for step, rows in enumerate(steps, 1):
            fx = features(lm_w, cfg["lm"], [r[5] for r in rows], rnd)
            fy = features(lm_w, cfg["lm"], [r[6] for r in rows], rnd)
            b = pair_batch(rows, fx, fy, device, dt)
            leaves = {k: p.detach().requires_grad_(True)
                      for k, p in params.items()}
            th, A = ref_heads.potentials(leaves, b["hx"], b["hy"], b["x_len"],
                                         b["y_len"], layers, rnd)
            ddt = dp_dtype or dt
            E = nw.expected(th.to(ddt), A.to(ddt), b["x_len"], b["y_len"],
                            create_graph=True)
            loss = ref_train.cross_entropy(b["target"].to(ddt), E, b["x_len"],
                                           b["y_len"], b["gmask"])
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            grads = ref_train.clip_global(grads, t["grad_clip"])
            if first is None:
                first = {k: g.detach().double() for k, g in grads.items()}
            losses.append(float(loss.detach()))
            with torch.no_grad():
                ref_train.adamw(params, {k: g.detach() for k, g in grads.items()},
                                state, step, t["learning_rate"],
                                tuple(t["betas"]), t["eps"], t["weight_decay"])
            del E, loss, grads, leaves, th, A, b
    return losses, first, {k: p.double() for k, p in params.items()}
