"""FCOS: ResNet + FPN (p3-p7), per-location classification, (l, t, r, b)
distances and centerness, with center sampling and per-level size ranges;
anchor-free.

Counterpart of ``vnext_tpu.models.fcos`` (reference surface:
detectron2/modeling/meta_arch/fcos.py). Module and parameter names follow the
flax tree (``head.cls_conv{i}``, ``head.box_conv{i}``, ``head.cls_score``,
``head.bbox_pred``, ``head.centerness`` and the per-level ``head.scales``).
The JAX package's choices are kept: a point is assigned the ground truth of
smallest area among those whose box and 1.5-stride centre region hold it and
whose size range fits (ties to the first slot, as ``jnp.argmin``); the box
loss is 1 - GIoU weighted by the centerness target; inference scores
sqrt(sigmoid(class) x sigmoid(centerness)) and takes each point's best class,
the per-image top ``test_topk``, class-aware NMS at 0.6 and the top
``max_detections``, with stable top-k. The model computes in f32, as
RetinaNet does (``models.build_model``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.losses import sigmoid_bce_with_logits, sigmoid_focal_loss_elementwise
from ..structures.boxes import elementwise_giou_loss
from .layers import Conv
from .rcnn import DetTargets
from .retinanet import (FOCAL_ALPHA, FOCAL_GAMMA, STRIDES, DenseDetector, _run_towers, _towers, flatten_levels,
                        prior_bias)

INF = 1e8
SIZE_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))     # the largest distance, p3-p7
CENTER_SAMPLE_RADIUS = 1.5                                                    # in strides


class FCOSHead(nn.Module):
    """The 4-conv class and box towers, ``cls_score`` (bias at the prior
    probability), ``bbox_pred`` and ``centerness`` off the box tower, and one
    learned scale a level: distances relu(bbox_pred x scale) in f32."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        _towers(self, in_channels)
        self.cls_score = Conv(in_channels, num_classes, 3, 1, 1, bias_init=prior_bias())
        self.bbox_pred = Conv(in_channels, 4, 3, 1, 1)
        self.centerness = Conv(in_channels, 1, 3, 1, 1)
        self.scales = nn.Parameter(torch.empty(len(STRIDES), dtype=torch.float32))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.ones_(self.scales)

    def forward(self, features: List[torch.Tensor]):
        logits, regs, ctrs = [], [], []
        for lvl, f in enumerate(features):
            c, b = _run_towers(self, f)
            logits.append(self.cls_score(c))
            regs.append(torch.relu(self.bbox_pred(b).float() * self.scales[lvl]))
            ctrs.append(self.centerness(b))
        return logits, regs, ctrs


class FCOS(DenseDetector):
    """``forward(images, targets)`` in train mode returns loss_fcos_cls,
    loss_fcos_loc and loss_fcos_ctr; ``inference(images)`` as RetinaNet's."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50, fpn_channels: int = 256,
                 test_score_thresh: float = 0.05, max_detections: int = 100):
        super().__init__(num_classes, backbone_depth, fpn_channels, test_score_thresh, 0.6, max_detections)
        self.head = FCOSHead(fpn_channels, num_classes)
        self._points: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}

    def points(self, features: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Every level's cell centres (x, y) [N, 2], each point's stride [N] and
        size range [N, 2], in (level, y, x) order; made once per level shapes."""
        shapes = tuple(tuple(f.shape[-2:]) for f in features)
        dev = features[0].device
        key = (shapes, str(dev))
        if key not in self._points:
            pts, strides, ranges = [], [], []
            for lvl, (h, w) in enumerate(shapes):
                s = STRIDES[lvl]
                ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * s
                xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * s
                yy, xx = torch.meshgrid(ys, xs, indexing="ij")
                pts.append(torch.stack([xx.reshape(-1), yy.reshape(-1)], -1))
                strides.append(torch.full((h * w,), float(s), device=dev))
                ranges.append(torch.tensor([SIZE_RANGES[lvl]], dtype=torch.float32, device=dev).expand(h * w, 2))
            self._points[key] = (torch.cat(pts), torch.cat(strides), torch.cat(ranges))
        return self._points[key]

    def assign(self, points: torch.Tensor, strides: torch.Tensor, ranges: torch.Tensor, gt_boxes: torch.Tensor,
               gt_valid: torch.Tensor):
        """One image's assignment: (matched slot [N], foreground [N], the
        distances to every ground truth [N, K, 4]) for boxes [K, 4]."""
        x, y = points[:, 0:1], points[:, 1:2]
        reg = torch.stack([x - gt_boxes[None, :, 0], y - gt_boxes[None, :, 1],
                           gt_boxes[None, :, 2] - x, gt_boxes[None, :, 3] - y], -1)
        in_box = reg.amin(-1) > 0
        cx = (gt_boxes[:, 0] + gt_boxes[:, 2]) / 2
        cy = (gt_boxes[:, 1] + gt_boxes[:, 3]) / 2
        radius = CENTER_SAMPLE_RADIUS * strides[:, None]
        in_center = ((x - cx[None]).abs() < radius) & ((y - cy[None]).abs() < radius)
        max_reg = reg.amax(-1)
        in_range = (max_reg >= ranges[:, 0:1]) & (max_reg <= ranges[:, 1:2])
        area = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
        candidate = in_box & in_center & in_range & gt_valid[None, :]
        matched = torch.where(candidate, area[None, :], torch.full_like(candidate, INF, dtype=area.dtype)).argmin(1)
        return matched, candidate.any(1), reg

    def _outputs(self, images: torch.Tensor):
        """(logits [B, N, C], distances [B, N, 4], centerness [B, N], points,
        strides, ranges)."""
        features = self._features(images)
        logits_l, regs_l, ctrs_l = self.head(features)
        return (flatten_levels(logits_l, self.num_classes), flatten_levels(regs_l, 4),
                flatten_levels(ctrs_l, 1)[..., 0], *self.points(features))

    @staticmethod
    def decode(points: torch.Tensor, strides: torch.Tensor, regs: torch.Tensor) -> torch.Tensor:
        """Boxes [B, N, 4] from the predicted distances in strides."""
        px, py, s = points[None, :, 0], points[None, :, 1], strides[None]
        return torch.stack([px - regs[..., 0] * s, py - regs[..., 1] * s,
                            px + regs[..., 2] * s, py + regs[..., 3] * s], -1)

    def match(self, points, strides, ranges, targets: DetTargets):
        """Per image: (matched slot [B, N], foreground [B, N], distances [B, N, K, 4])."""
        out = [self.assign(points, strides, ranges, g, v) for g, v in zip(targets.boxes, targets.valid)]
        return tuple(torch.stack(t) for t in zip(*out))

    def losses(self, logits, regs, ctrs, points, strides, ranges, targets: DetTargets) -> Dict[str, torch.Tensor]:
        c = self.num_classes
        with torch.no_grad():
            matched, fg, reg_all = self.match(points, strides, ranges, targets)
            gt_cls = targets.labels.gather(1, matched).long()
            onehot = F.one_hot(torch.where(fg, gt_cls, c), c + 1)[..., :-1].float()
            num_fg = fg.sum().clamp_min(1).float()
            gt_reg = reg_all.gather(2, matched[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
            px, py = points[None, :, 0], points[None, :, 1]
            gt_boxes = torch.stack([px - gt_reg[..., 0], py - gt_reg[..., 1],
                                    px + gt_reg[..., 2], py + gt_reg[..., 3]], -1)
            lr, tb = gt_reg[..., [0, 2]], gt_reg[..., [1, 3]]
            ctr_target = torch.sqrt((lr.amin(-1) / lr.amax(-1).clamp_min(1e-6)).clamp(0, 1)
                                    * (tb.amin(-1) / tb.amax(-1).clamp_min(1e-6)).clamp(0, 1))
            fgf = fg.float()
        loss_cls = sigmoid_focal_loss_elementwise(logits, onehot, FOCAL_ALPHA, FOCAL_GAMMA).sum() / num_fg
        giou = elementwise_giou_loss(self.decode(points, strides, regs), gt_boxes)
        loss_box = (giou * ctr_target * fgf).sum() / (ctr_target * fgf).sum().clamp_min(1e-6)
        loss_ctr = (sigmoid_bce_with_logits(ctrs, ctr_target) * fgf).sum() / num_fg
        return {"loss_fcos_cls": loss_cls, "loss_fcos_loc": loss_box, "loss_fcos_ctr": loss_ctr}

    def inference(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits, regs, ctrs, points, strides, _ = self._outputs(images)
        scores = torch.sqrt(torch.sigmoid(logits) * torch.sigmoid(ctrs)[..., None])
        return self.select(scores, self.decode(points, strides, regs))
