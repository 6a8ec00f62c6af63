"""Edge-set ROC statistics of alignments (own copies of ``ROC_COLUMNS``,
``roc_edges`` and ``filter_gaps`` from ``deepblast_tpu/eval/score.py:33-66``).
"""

from __future__ import annotations

from deepblast_torch.data.state_utils import m as match

__all__ = ["ROC_COLUMNS", "roc_edges", "filter_gaps"]

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


def filter_gaps(states, edges):
    """Keep only match-state edges."""
    return [e for s, e in zip(states, edges) if s == match]
