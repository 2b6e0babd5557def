"""Evaluation metrics (counterpart of sam_road_tpu/ops/metrics.py): IoU and
F1 as streaming counts on the device, 4096-bin score histograms per class
for the PR curve, and the best-F1 threshold search on the host."""

from __future__ import annotations

import numpy as np
import torch

PR_BINS = 4096


def binary_iou_counts(scores, targets, threshold: float = 0.5, weights=None):
    """(intersection, union) at `threshold`; `weights` (broadcastable to
    scores) down-weights entries, as validation does for padding samples."""
    pred = scores >= threshold
    tgt = targets >= 0.5
    inter = (pred & tgt).float()
    union = (pred | tgt).float()
    if weights is not None:
        inter, union = inter * weights, union * weights
    return inter.sum(), union.sum()


def binary_f1_counts(scores, targets, threshold: float = 0.5, ignore_index: int = -1,
                     weights=None):
    """(tp, fp, fn), ignoring entries whose target is `ignore_index`."""
    keep = targets != ignore_index
    pred = (scores >= threshold) & keep
    tgt = (targets == 1) & keep
    tp, fp, fn = (pred & tgt).float(), (pred & ~tgt).float(), (~pred & tgt).float()
    if weights is not None:
        tp, fp, fn = tp * weights, fp * weights, fn * weights
    return tp.sum(), fp.sum(), fn.sum()


def pr_histogram(scores, targets, ignore_index: int = -1, weights=None):
    """Score histograms of positives and negatives -> (pos, neg), each
    [PR_BINS] fp32; bin = clip(int(score * PR_BINS), 0, PR_BINS - 1)."""
    keep = targets != ignore_index
    bins = (scores * PR_BINS).to(torch.int32).clamp(0, PR_BINS - 1).reshape(-1).long()
    pos = (keep & (targets == 1)).float()
    neg = (keep & (targets != 1)).float()
    if weights is not None:
        pos, neg = pos * weights, neg * weights
    zeros = torch.zeros(PR_BINS, dtype=torch.float32, device=scores.device)
    return (zeros.index_add(0, bins, pos.reshape(-1)),
            zeros.index_add(0, bins, neg.reshape(-1)))


def pr_curve_from_histograms(pos_hist, neg_hist):
    """(precision, recall, thresholds) with thresholds k / PR_BINS; a score
    counts as positive when >= the threshold (torchmetrics semantics)."""
    pos_hist = np.asarray(pos_hist, np.float64)
    neg_hist = np.asarray(neg_hist, np.float64)
    tp = np.cumsum(pos_hist[::-1])[::-1]
    fp = np.cumsum(neg_hist[::-1])[::-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / (tp + fp), 1.0)
        recall = tp / max(pos_hist.sum(), 1.0)
    return precision, recall, np.arange(PR_BINS) / PR_BINS


def find_best_threshold(pos_hist, neg_hist):
    """Best-F1 threshold from the two histograms."""
    precision, recall, thresholds = pr_curve_from_histograms(pos_hist, neg_hist)
    with np.errstate(divide="ignore", invalid="ignore"):
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / (precision + recall), 0.0)
    k = int(np.nanargmax(f1))
    return {"threshold": float(thresholds[k]), "precision": float(precision[k]),
            "recall": float(recall[k]), "f1": float(f1[k])}
