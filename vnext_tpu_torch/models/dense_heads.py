"""Dense-detector building blocks: anchors, the box transform, the IoU matcher.

Counterpart of ``vnext_tpu.models.dense_heads`` (reference surface:
detectron2/modeling/anchor_generator.py DefaultAnchorGenerator,
box_regression.py Box2BoxTransform, matcher.py Matcher). Anchors are made on
the host in numpy, as the JAX package makes them, and moved to the caller's
device; a level's anchors run rows, then columns, then cell anchors.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..structures.boxes import pairwise_iou


def generate_cell_anchors(sizes: Sequence[float] = (32, 64, 128, 256, 512),
                          aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0)) -> np.ndarray:
    """[len(sizes) * len(ratios), 4] xyxy anchors centred at (0, 0)."""
    anchors = []
    for size in sizes:
        area = size ** 2
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, np.float32)


def anchors_for_level(feat_h: int, feat_w: int, stride: int, cell_anchors: np.ndarray,
                      device=None) -> torch.Tensor:
    """[H * W * A, 4] anchors of one feature level: the cell anchors shifted to
    each cell's centre, in (y, x, anchor) order."""
    shifts_x = (np.arange(feat_w) + 0.5) * stride
    shifts_y = (np.arange(feat_h) + 0.5) * stride
    sx, sy = np.meshgrid(shifts_x, shifts_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    out = (shifts[:, None, :] + cell_anchors[None, :, :]).reshape(-1, 4).astype(np.float32)
    return torch.from_numpy(out).to(device)


class Box2BoxTransform:
    """(dx, dy, dw, dh) anchor-relative box parameterization (box_regression.py),
    the log-size deltas clamped at ``scale_clamp`` before the exponential."""

    def __init__(self, weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
                 scale_clamp: float = math.log(1000.0 / 16)):
        self.weights = weights
        self.scale_clamp = scale_clamp

    def get_deltas(self, src_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
        sw = src_boxes[..., 2] - src_boxes[..., 0]
        sh = src_boxes[..., 3] - src_boxes[..., 1]
        sx = src_boxes[..., 0] + 0.5 * sw
        sy = src_boxes[..., 1] + 0.5 * sh
        tw = target_boxes[..., 2] - target_boxes[..., 0]
        th = target_boxes[..., 3] - target_boxes[..., 1]
        tx = target_boxes[..., 0] + 0.5 * tw
        ty = target_boxes[..., 1] + 0.5 * th
        wx, wy, ww, wh = self.weights
        return torch.stack([
            wx * (tx - sx) / sw.clamp_min(1e-6),
            wy * (ty - sy) / sh.clamp_min(1e-6),
            ww * torch.log(tw.clamp_min(1e-6) / sw.clamp_min(1e-6)),
            wh * torch.log(th.clamp_min(1e-6) / sh.clamp_min(1e-6)),
        ], -1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        cx = boxes[..., 0] + 0.5 * w
        cy = boxes[..., 1] + 0.5 * h
        wx, wy, ww, wh = self.weights
        dx = deltas[..., 0] / wx
        dy = deltas[..., 1] / wy
        dw = (deltas[..., 2] / ww).clamp_max(self.scale_clamp)
        dh = (deltas[..., 3] / wh).clamp_max(self.scale_clamp)
        pcx = dx * w + cx
        pcy = dy * h + cy
        pw = torch.exp(dw) * w
        ph = torch.exp(dh) * h
        return torch.stack([pcx - pw / 2, pcy - ph / 2, pcx + pw / 2, pcy + ph / 2], -1)


def iou_matcher(gt_boxes: torch.Tensor, gt_valid: torch.Tensor, anchors: torch.Tensor,
                thresholds: Tuple[float, float] = (0.4, 0.5),
                allow_low_quality_matches: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(matched_gt_idx [N], match_labels [N]: 1 foreground, 0 background, -1
    ignored) of anchors [N, 4] against gt_boxes [K, 4] (``gt_valid`` [K]):
    IoU >= hi is foreground, < lo background, between them ignored; with low-
    quality matches each ground truth's best anchors (within 1e-5) are
    foreground. Ties of the best IoU go to the lower index, as ``jnp.argmax``."""
    iou = pairwise_iou(gt_boxes, anchors)
    iou = torch.where(gt_valid[:, None], iou, torch.full_like(iou, -1.0))
    matched_vals, matched_idx = iou.amax(0), iou.argmax(0)     # argmax: the first maximal index
    lo, hi = thresholds
    labels = torch.where(matched_vals >= hi, 1, torch.where(matched_vals < lo, 0, -1))
    if allow_low_quality_matches:
        best_per_gt = iou.amax(1, keepdim=True)
        is_best = (iou >= best_per_gt - 1e-5) & (best_per_gt > 0) & gt_valid[:, None]
        labels = torch.where(is_best.any(0), 1, labels)
    return matched_idx, labels.to(torch.int32)
