"""Detection and segmentation losses, with validity masks so that padded rows
contribute exactly zero.

Counterpart of ``vnext_tpu.ops.losses`` (``sigmoid_bce_with_logits``,
``sigmoid_focal_loss_elementwise``, ``sigmoid_focal_loss``, ``dice_loss``,
``diou_loss``, ``ciou_loss``).
"""

from __future__ import annotations

import math
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


def _iou_parts(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float):
    """(IoU, w, h, wg, hg) of xyxy pairs [..., 4]."""
    x1, y1, x2, y2 = boxes1.unbind(-1)
    x1g, y1g, x2g, y2g = boxes2.unbind(-1)
    w, h, wg, hg = x2 - x1, y2 - y1, x2g - x1g, y2g - y1g
    inter = (torch.minimum(x2, x2g) - torch.maximum(x1, x1g)).clamp_min(0) * \
        (torch.minimum(y2, y2g) - torch.maximum(y1, y1g)).clamp_min(0)
    union = w * h + wg * hg - inter
    return inter / (union + eps), w, h, wg, hg


def diou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Distance-IoU loss, elementwise over [..., 4] xyxy pairs (detectron2's
    layers/losses.py:9): 1 - IoU + d^2(centres) / c^2(the enclosing box's diagonal)."""
    x1, y1, x2, y2 = boxes1.unbind(-1)
    x1g, y1g, x2g, y2g = boxes2.unbind(-1)
    iou = _iou_parts(boxes1, boxes2, eps)[0]
    diag = (torch.maximum(x2, x2g) - torch.minimum(x1, x1g)) ** 2 + \
        (torch.maximum(y2, y2g) - torch.minimum(y1, y1g)) ** 2 + eps
    d2 = ((x1 + x2 - x1g - x2g) ** 2 + (y1 + y2 - y1g - y2g) ** 2) / 4.0
    return 1.0 - iou + d2 / diag


def ciou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete-IoU loss (detectron2's layers/losses.py:64): DIoU plus the
    aspect-ratio term alpha * v, alpha detached as the reference weighs it."""
    iou, w, h, wg, hg = _iou_parts(boxes1, boxes2, eps)
    v = (4.0 / math.pi ** 2) * (torch.atan(wg / (hg + eps)) - torch.atan(w / (h + eps))) ** 2
    alpha = (v / (1.0 - iou + v + eps)).detach()
    return diou_loss(boxes1, boxes2, eps) + alpha * v
