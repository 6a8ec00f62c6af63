"""Alignment-accuracy scoring (own copies from
``deepblast_tpu/eval/score.py:33-155``): edge-set ROC statistics, the
kernelised (position-tolerant) identity, a text render, and a
``multiprocessing`` map over rows (:func:`score_alignments`).

``alignment_visualization`` (a matplotlib figure) is not ported: it waits
for ROADMAP.md queue A item 7 with the trainer's figures and TensorBoard.
"""

from __future__ import annotations

import multiprocessing

import numpy as np

from deepblast_torch.data.state_utils import m as match
from deepblast_torch.data.state_utils import (
    states2alignment,
    states2edges,
    tmstate_f,
)

__all__ = [
    "ROC_COLUMNS",
    "roc_edges",
    "roc_edges_kernel_identity",
    "filter_gaps",
    "alignment_score",
    "alignment_score_kernel",
    "alignment_text",
    "score_alignments",
]

ROC_COLUMNS = ["tp", "fp", "fn", "perc_id", "ppv", "fnr", "fdr"]


def roc_edges(true_edges, pred_edges):
    """tp/fp/fn and derived rates over edge sets."""
    truth = set(map(tuple, true_edges))
    pred = set(map(tuple, pred_edges))
    tp = len(truth & pred)
    fp = len(pred - truth)
    fn = len(truth - pred)
    perc_id = tp / len(true_edges)
    ppv = tp / (tp + fp) if tp + fp else 0.0
    fnr = fn / (fn + tp) if fn + tp else 0.0
    fdr = fp / (fp + tp) if fp + tp else 0.0
    return tp, fp, fn, perc_id, ppv, fnr, fdr


def roc_edges_kernel_identity(true_edges, pred_edges, kernel_width):
    """Tolerant identity: a true edge counts when a predicted edge, or one
    shifted by up to ``kernel_width - 1`` along the diagonal either way,
    hits it."""
    pe_ = list(map(tuple, pred_edges))
    pe = np.array(pred_edges)
    for k in range(kernel_width):
        pe_ += list(map(tuple, pe + k))
        pe_ += list(map(tuple, pe - k))
    truth = set(map(tuple, true_edges))
    tp = len(truth & set(pe_))
    return tp / len(true_edges)


def filter_gaps(states, edges):
    """Keep only match-state edges."""
    return [e for s, e in zip(states, edges) if s == match]


def alignment_score(true_states, pred_states, no_gaps=True):
    """ROC statistics of two state strings (TM-align characters) or state
    sequences."""
    pred = [tmstate_f(s) for s in pred_states] \
        if isinstance(pred_states, str) else list(pred_states)
    true = [tmstate_f(s) for s in true_states] \
        if isinstance(true_states, str) else list(true_states)
    pred_edges = states2edges(pred)
    true_edges = states2edges(true)
    if no_gaps:
        pred_edges = filter_gaps(pred, pred_edges)
        true_edges = filter_gaps(true, true_edges)
    return roc_edges(true_edges, pred_edges)


def alignment_score_kernel(true_states, pred_states, kernel_widths,
                           query_offset=0, hit_offset=0, no_gaps=True):
    """Kernelised identities, one a width, of a predicted state string
    whose edges start at ``(query_offset, hit_offset)`` (a local
    alignment)."""
    pred = [tmstate_f(s) for s in pred_states]
    true = [tmstate_f(s) for s in true_states]
    pred_edges = np.array(states2edges(pred))
    pred_edges[:, 0] += query_offset
    pred_edges[:, 1] += hit_offset
    pred_edges = list(map(tuple, pred_edges))
    true_edges = list(map(tuple, np.array(states2edges(true))))
    if no_gaps:
        pred_edges = filter_gaps(pred, pred_edges)
        true_edges = filter_gaps(true, true_edges)
    return [roc_edges_kernel_identity(true_edges, pred_edges, k)
            for k in kernel_widths]


def alignment_text(x, y, pred, truth, stats):
    """The true and predicted alignments of ``x`` and ``y`` and the ROC
    statistics, as text."""
    true_alignment = states2alignment(np.asarray(truth), x, y)
    pred_alignment = states2alignment(np.asarray(pred), x, y)
    stats = [np.round(s, 2) for s in stats]
    stats_viz = " ".join(
        f"{c}: {s}" for c, s in zip(ROC_COLUMNS, stats))
    return (stats_viz
            + "\n# Ground truth\n"
            + f"    {true_alignment[0]}\n    {true_alignment[1]}"
            + "\n# Prediction\n"
            + f"    {pred_alignment[0]}\n    {pred_alignment[1]}")


def _score_row(args):
    true, pred, widths, qo, ho = args
    return alignment_score_kernel(true, pred, widths, qo, ho)


def score_alignments(rows, kernel_widths=(1,), n_cores=4):
    """Kernelised identities of ``(true, pred[, q_off, h_off])`` rows, in
    ``n_cores`` processes (started with ``spawn``) from 4 rows on."""
    work = []
    for r in rows:
        true, pred = r[0], r[1]
        qo = r[2] if len(r) > 2 else 0
        ho = r[3] if len(r) > 3 else 0
        work.append((true, pred, list(kernel_widths), qo, ho))
    if n_cores <= 1 or len(work) < 4:
        return [_score_row(w) for w in work]
    with multiprocessing.get_context("spawn").Pool(n_cores) as pool:
        return pool.map(_score_row, work)
