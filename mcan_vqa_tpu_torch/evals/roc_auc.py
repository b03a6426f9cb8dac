"""ROC-AUC of multi-label predictions (the port's copy of
mcan_vqa_tpu/evals/roc_auc.py): per class, micro and macro, as the
reference prints them with sklearn (core/exec.py:399-408), here in numpy
through the Mann-Whitney statistic with midranks for ties."""

from __future__ import annotations

from typing import Dict

import numpy as np


def binary_roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """The AUC as the Mann-Whitney U statistic, tied scores at their
    midrank. nan when only one class is present or a score is nan (an eval
    loop skips it; sklearn would raise)."""
    y_true = np.asarray(y_true).astype(bool).ravel()
    y_score = np.asarray(y_score, np.float64).ravel()
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    if np.isnan(y_score).any():
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(y_score.size, np.float64)
    _, inv, counts = np.unique(y_score[order], return_inverse=True,
                               return_counts=True)
    cum = np.cumsum(counts)
    mid = cum - (counts - 1) / 2.0   # the mean of ranks cum-count+1 .. cum
    ranks[order] = mid[inv]
    rank_sum_pos = ranks[y_true].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def multilabel_roc_auc(y_true: np.ndarray, y_score: np.ndarray
                       ) -> Dict[str, object]:
    """y_true [N, C] multi-hot, y_score [N, C] probabilities ->
    {"per_class": C floats (nan where a class is one-sided), "macro": their
    mean over the valid classes, "micro": the AUC of the flattened
    matrix}."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    assert y_true.shape == y_score.shape and y_true.ndim == 2
    per_class = [binary_roc_auc(y_true[:, c], y_score[:, c])
                 for c in range(y_true.shape[1])]
    valid = [a for a in per_class if not np.isnan(a)]
    return {
        "per_class": per_class,
        "macro": float(np.mean(valid)) if valid else float("nan"),
        "micro": binary_roc_auc(y_true.ravel(), y_score.ravel()),
    }
