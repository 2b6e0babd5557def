"""Training losses (counterpart of sam_road_tpu/ops/losses.py), all in
float32 whatever the activation dtype."""

from __future__ import annotations

import torch


def _reduce(loss, reduction: str):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def bce_with_logits(logits, targets, reduction: str = "mean"):
    """Stable binary cross entropy on logits, max(x, 0) - x z + log(1 +
    exp(-|x|)) (torch BCEWithLogitsLoss semantics)."""
    x = logits.float()
    z = targets.float()
    loss = x.clamp(min=0) - x * z + torch.log1p(torch.exp(-x.abs()))
    return _reduce(loss, reduction)


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0,
                       reduction: str = "mean"):
    """torchvision.ops.sigmoid_focal_loss semantics."""
    x = logits.float()
    z = targets.float()
    p = torch.sigmoid(x)
    ce = bce_with_logits(x, z, reduction="none")
    p_t = p * z + (1 - p) * (1 - z)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * z + (1 - alpha) * (1 - z)) * loss
    return _reduce(loss, reduction)


def masked_topo_loss(topo_logits, connected, valid, denominator=None):
    """BCE over topology pairs, masked by `valid` and normalised by the
    valid count (at least 1). topo_logits [B, S, K, 1]; connected, valid
    [B, S, K]. `denominator` replaces the local count: a data-parallel rank
    passes the global one over the world size (training/harness.py), so
    the ranks' mean is JAX's loss over the global batch."""
    gt = connected.float()[..., None]
    mask = valid.float()[..., None]
    loss = bce_with_logits(topo_logits, gt, reduction="none") * mask
    return loss.sum() / (mask.sum().clamp(min=1.0) if denominator is None else denominator)
