"""Evaluation metrics: per-class AP, ROC-AUC and d-prime, in numpy.

The port's counterpart of the JAX package's ``engine/metrics.py``, with
the semantics of sklearn's ``average_precision_score`` and
``roc_auc_score`` (per class, ``average=None``) computed here without
sklearn, vectorised over classes:

 - AP = sum over distinct thresholds, from the highest score down, of
   (R_n - R_(n-1)) * P_n; tied scores form one step;
 - AUC = the trapezoid under the ROC curve through the distinct
   thresholds; a tie of a positive and a negative counts one half.

Classes without positives get NaN for AP; classes without positives or
without negatives get NaN for AUC (where sklearn raises). Summaries are
NaN means (pytorch/evaluate.py:44-58, utilities.py:246-248).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy.stats import norm

# classes per chunk: bounds the (N, chunk) work arrays (about 20 MB each
# for the 20k-clip eval set)
_CHUNK = 128


def d_prime(auc: np.ndarray) -> np.ndarray:
    return np.sqrt(2.0) * norm.ppf(auc)


def _ranked(scores: np.ndarray, target: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Per column, sorted by descending score: the targets, the running
    count of positives, and for each row the running count at the end of
    its tie group and at the end of the group before it."""
    n = scores.shape[0]
    order = np.argsort(-scores, axis=0, kind="stable")
    s = np.take_along_axis(scores, order, axis=0)
    y = np.take_along_axis(target, order, axis=0).astype(np.float64)
    tps = np.cumsum(y, axis=0)
    rows = np.arange(n)[:, None]
    change = s[1:] != s[:-1]  # a new tie group starts at row i+1
    last = np.concatenate([change, np.ones((1, s.shape[1]), bool)])
    first = np.concatenate([np.ones((1, s.shape[1]), bool), change])
    end = np.minimum.accumulate(np.where(last, rows, n)[::-1], axis=0)[::-1]
    start = np.maximum.accumulate(np.where(first, rows, 0), axis=0)
    tps_end = np.take_along_axis(tps, end, axis=0)
    tps_before = np.where(start > 0, np.take_along_axis(tps, np.maximum(start - 1, 0), axis=0), 0.0)
    return y, end, tps_end, tps_before


def _ap_auc(scores: np.ndarray, target: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    y, end, tps_end, tps_before = _ranked(scores, target)
    pos = y.sum(axis=0)
    neg = y.shape[0] - pos
    with np.errstate(invalid="ignore", divide="ignore"):
        # each positive adds 1/P of recall at the precision of its group's end
        precision_end = tps_end / (end + 1.0)
        ap = (y * precision_end).sum(axis=0) / pos
        # each negative adds 1/Nn of false-positive rate at the mean of the
        # true-positive rates at the start and end of its group
        auc = ((1.0 - y) * (tps_before + tps_end)).sum(axis=0) / (2.0 * pos * neg)
    return ap, auc


def evaluate_clipwise(clipwise_output: np.ndarray, target: np.ndarray) -> Dict[str, np.ndarray]:
    """(N, C) scores and (N, C) multi-hot targets -> per-class statistics
    {'average_precision', 'auc', 'd_prime'}, each (C,)."""
    scores = np.asarray(clipwise_output)
    if not np.issubdtype(scores.dtype, np.floating):
        scores = scores.astype(np.float64)
    target = np.asarray(target)
    n_classes = target.shape[1]
    pos = target.sum(axis=0)
    ap = np.full(n_classes, np.nan)
    auc = np.full(n_classes, np.nan)
    for c0 in range(0, n_classes, _CHUNK):
        sl = slice(c0, c0 + _CHUNK)
        ap[sl], auc[sl] = _ap_auc(scores[:, sl], target[:, sl])
    # AP needs a positive (sklearn computes it for all-positive classes
    # too); AUC also needs a negative
    ap[~(pos > 0)] = np.nan
    auc[~((pos > 0) & (pos < target.shape[0]))] = np.nan
    return {"average_precision": ap, "auc": auc, "d_prime": d_prime(auc)}


def summarize(statistics: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Macro averages: mAP, mAUC and d-prime of the mean AUC
    (evaluate_convnext_on_audioset.py:93-105)."""
    m_ap = float(np.nanmean(statistics["average_precision"]))
    m_auc = float(np.nanmean(statistics["auc"]))
    return {"mAP": m_ap, "mAUC": m_auc, "dprime": float(d_prime(np.array(m_auc)))}
