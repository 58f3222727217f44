"""Metrics: AUC (rank-based, the MLPerf DLRM quality metric), logloss,
plus a streaming-AUC accumulator (fixed-bin histogram) for large eval sets.
numpy only: a copy of ``repro.train.metrics``, kept by the port so that it
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact ROC-AUC via the rank statistic (ties handled by mid-ranks)."""
    labels = np.asarray(labels).astype(np.int64).ravel()
    scores = np.asarray(scores, np.float64).ravel()
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and \
                sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * ((i + 1) + (j + 1))
        i = j + 1
    sum_pos = ranks[labels == 1].sum()
    return float((sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


class StreamingAuc:
    """Histogram-binned AUC over sigmoid scores (O(1) memory per batch)."""

    def __init__(self, n_bins: int = 8192):
        self.n_bins = n_bins
        self.pos = np.zeros(n_bins, np.int64)
        self.neg = np.zeros(n_bins, np.int64)

    def update(self, labels: np.ndarray, logits: np.ndarray) -> None:
        p = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64).ravel()))
        b = np.minimum((p * self.n_bins).astype(np.int64), self.n_bins - 1)
        lab = np.asarray(labels).astype(bool).ravel()
        np.add.at(self.pos, b[lab], 1)
        np.add.at(self.neg, b[~lab], 1)

    def value(self) -> float:
        n_pos, n_neg = self.pos.sum(), self.neg.sum()
        if n_pos == 0 or n_neg == 0:
            return 0.5
        # P(score_pos > score_neg) + ½ P(tie), bin-wise
        cum_neg = np.concatenate([[0], np.cumsum(self.neg)[:-1]])
        wins = (self.pos * cum_neg).sum()
        ties = (self.pos * self.neg).sum()
        return float((wins + 0.5 * ties) / (n_pos * n_neg))


def logloss(labels: np.ndarray, logits: np.ndarray) -> float:
    y = np.asarray(labels, np.float64).ravel()
    z = np.asarray(logits, np.float64).ravel()
    return float(np.mean(np.maximum(z, 0) - z * y + np.log1p(np.exp(-np.abs(z)))))
