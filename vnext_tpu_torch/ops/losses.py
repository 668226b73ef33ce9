"""Detection and segmentation losses, with validity masks so that padded rows
contribute exactly zero.

Counterpart of ``vnext_tpu.ops.losses`` (``sigmoid_bce_with_logits``,
``sigmoid_focal_loss_elementwise``, ``sigmoid_focal_loss``, ``dice_loss``).
"""

from __future__ import annotations

from typing import Optional

import torch


def sigmoid_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy with logits (stable)."""
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss_elementwise(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    prob = torch.sigmoid(logits)
    ce = sigmoid_bce_with_logits(logits, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss


def sigmoid_focal_loss(logits, targets, num_boxes, alpha: float = 0.25, gamma: float = 2.0,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over all but the first dimension, then sum / num_boxes.
    logits / targets [N, ...]; valid: optional [N] mask zeroing padded rows."""
    loss = sigmoid_focal_loss_elementwise(logits, targets, alpha, gamma)
    per_row = loss.reshape(loss.shape[0], -1).mean(1)
    if valid is not None:
        per_row = per_row * valid.to(per_row.dtype)
    return per_row.sum() / num_boxes


def dice_loss(logits, targets, num_boxes, valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DICE loss over [N, ...] rows."""
    inputs = torch.sigmoid(logits).reshape(logits.shape[0], -1)
    targets = targets.reshape(targets.shape[0], -1).to(inputs.dtype)
    numerator = 2 * (inputs * targets).sum(1)
    denominator = inputs.sum(-1) + targets.sum(-1)
    loss = 1 - (numerator + 1) / (denominator + 1)
    if valid is not None:
        loss = loss * valid.to(loss.dtype)
    return loss.sum() / num_boxes
