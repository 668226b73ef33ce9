"""Box operations used by the matcher and the criterion.

Counterpart of the functions of ``vnext_tpu.structures.boxes`` that simOTA and
the set criterion use. Boxes are [..., 4]; the pairwise functions take sets
[..., N, 4] and [..., M, 4] with any leading batch dimensions and return
[..., N, M].
"""

from __future__ import annotations

import torch

_TINY = torch.finfo(torch.float32).tiny


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    xc, yc, w, h = x.unbind(-1)
    return torch.stack([xc - 0.5 * w, yc - 0.5 * h, xc + 0.5 * w, yc + 0.5 * h], -1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]).clamp_min(0) * (boxes[..., 3] - boxes[..., 1]).clamp_min(0)


def pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    return wh[..., 0] * wh[..., 1]


def _union(boxes1, boxes2, inter):
    return box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU between xyxy box sets."""
    inter = pairwise_intersection(boxes1, boxes2)
    return inter / _union(boxes1, boxes2, inter).clamp_min(_TINY)


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU between xyxy box sets."""
    inter = pairwise_intersection(boxes1, boxes2)
    union = _union(boxes1, boxes2, inter)
    iou = inter / union.clamp_min(_TINY)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    enclosing = wh[..., 0] * wh[..., 1]
    return iou - (enclosing - union) / enclosing.clamp_min(_TINY)


def elementwise_giou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Per-pair (aligned) 1 - GIoU for matched boxes, both (..., 4) xyxy."""
    x1 = torch.maximum(boxes1[..., 0], boxes2[..., 0])
    y1 = torch.maximum(boxes1[..., 1], boxes2[..., 1])
    x2 = torch.minimum(boxes1[..., 2], boxes2[..., 2])
    y2 = torch.minimum(boxes1[..., 3], boxes2[..., 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    union = box_area(boxes1) + box_area(boxes2) - inter
    iou = inter / union.clamp_min(_TINY)
    ex1 = torch.minimum(boxes1[..., 0], boxes2[..., 0])
    ey1 = torch.minimum(boxes1[..., 1], boxes2[..., 1])
    ex2 = torch.maximum(boxes1[..., 2], boxes2[..., 2])
    ey2 = torch.maximum(boxes1[..., 3], boxes2[..., 3])
    enclosing = (ex2 - ex1).clamp_min(0) * (ey2 - ey1).clamp_min(0)
    return 1.0 - (iou - (enclosing - union) / enclosing.clamp_min(_TINY))
