"""Matmul operations of DeepBLAST's model per pair, counting valid
residues only (padding is work the program chose, not work the model
needs).  A multiply-add is two operations.  Norms, softmax, activations
and the DP are left out: they are not matmul work."""

from __future__ import annotations

__all__ = ["t5_forward", "heads_forward", "heads_train", "potentials_forward",
           "potentials_train", "pair_train", "pair_serve"]


def t5_forward(n, lm):
    """One sequence of ``n`` residues through the encoder: the q, k, v, o
    projections, the feed-forward, and the scores and weighted values
    over the ``n`` valid keys."""
    d, inner, ff = lm["d_model"], lm["num_heads"] * lm["d_kv"], lm["d_ff"]
    per_layer = 2 * n * (4 * d * inner + 2 * d * ff) + 4 * n * n * inner
    return lm["num_layers"] * per_layer


def _head_terms(n, heads):
    """Forward operations of one head's layers: the embedding linear, then
    each convolution."""
    D, F, k = heads["embedding_dim"], heads["hidden_dim"], heads["k_size"]
    convs = [2 * n * (D if i == 0 else F) * F * k
             for i in range(heads["layers"])]
    return 2 * n * D * D, convs


def heads_forward(n, heads):
    """Both heads (match and gap) over one sequence, forward."""
    emb, convs = _head_terms(n, heads)
    return 2 * (emb + sum(convs))


def heads_train(n, heads):
    """Both heads over one sequence, forward and backward: every weight's
    gradient, and the gradient of every layer's input but the first (the
    LM's features need none)."""
    emb, convs = _head_terms(n, heads)
    fwd = emb + sum(convs)
    return 2 * (fwd + fwd + sum(convs))


def potentials_forward(n, m, heads):
    """The two ``(n, F) x (F, m)`` products of one pair."""
    return 2 * 2 * n * m * heads["hidden_dim"]


def potentials_train(n, m, heads):
    """The products and their gradients to both sides' features."""
    return 3 * potentials_forward(n, m, heads)


def pair_train(n, m, cfg):
    """A training pair: a frozen LM over both sequences, the heads and
    the potentials forward and backward."""
    lm, heads = cfg["lm"], cfg["heads"]
    return (t5_forward(n, lm) + t5_forward(m, lm) + heads_train(n, heads)
            + heads_train(m, heads) + potentials_train(n, m, heads))


def pair_serve(n, m, cfg):
    """A served pair: the LM, the heads and the potentials, forward."""
    lm, heads = cfg["lm"], cfg["heads"]
    return (t5_forward(n, lm) + t5_forward(m, lm) + heads_forward(n, heads)
            + heads_forward(m, heads) + potentials_forward(n, m, heads))
