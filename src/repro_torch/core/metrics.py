"""Accuracy and rank-based AUC (a copy of ``repro.core.metrics``; the AUC
is numpy, with ties given average ranks)."""

from __future__ import annotations

import numpy as np
import torch


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> float:
    return float((logits.argmax(-1) == labels).float().mean())


def binary_auc(scores, labels) -> float:
    """Mann-Whitney AUC with tie correction via average ranks."""
    if torch.is_tensor(scores):
        scores = scores.detach().cpu().numpy()
    if torch.is_tensor(labels):
        labels = labels.detach().cpu().numpy()
    s = np.asarray(scores, np.float64)
    labels_np = np.asarray(labels)
    order = np.argsort(s)
    sorted_s = s[order]
    r = np.arange(1, len(s) + 1, dtype=np.float64)
    uniq, inv, counts = np.unique(sorted_s, return_inverse=True, return_counts=True)
    sums = np.zeros(len(uniq))
    np.add.at(sums, inv, r)
    mean_ranks = sums / counts
    ranks = np.empty(len(s))
    ranks[order] = mean_ranks[inv]
    n_pos = int(labels_np.sum())
    n_neg = len(labels_np) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[labels_np == 1].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
