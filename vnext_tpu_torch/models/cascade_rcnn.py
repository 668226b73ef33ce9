"""Cascade R-CNN's ROI heads: three box stages at rising IoU thresholds.

Counterpart of ``vnext_tpu.models.cascade_rcnn`` (reference surface:
detectron2/modeling/roi_heads/cascade_rcnn.py CascadeROIHeads). Each stage
``stage{k}`` is a 2-fc head with class logits and class-agnostic deltas under
its own box transform (weights 10/20/30 on the centre, 5/10/15 on the size).
Training: stage 0 matches the proposals and the ground-truth slots at IoU 0.5
and samples ``batch_per_image`` ROIs at ``pos_fraction`` foreground (the RPN's
sampling, ``rcnn._sample``); later stages relabel the refined boxes at 0.6
and 0.7 without resampling. Each stage hands the next its boxes refined by its
own deltas, detached, and clipped to the image; the ROIs themselves stay
differentiable, as in JAX. Inference averages the stages' softmaxes, each
over its own stage's boxes, and keeps the last stage's boxes. The cascade is
box-only, as the JAX package's.

Every discrete choice goes through ``models/rcnn.py``'s functions (the
matcher, the sampling, the FPN level assignment, the clip), looked up there at
call time, so that the RPN's and the stages' choices are one sequence that a
caller may record and replay.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from . import rcnn
from .dense_heads import Box2BoxTransform
from .layers import Dense

# each stage's foreground IoU and its box transform's weights (reference cascade_rcnn.py defaults)
STAGE_IOUS = (0.5, 0.6, 0.7)
STAGE_WEIGHTS = ((10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0), (30.0, 30.0, 15.0, 15.0))
POOLER_SIZE, POOLER_LEVELS, FC_DIM = 7, (2, 5), 1024


class _CascadeBoxHead(nn.Module):
    """fc1, fc2 (ReLU), cls_score (C + 1) and bbox_pred (4, class-agnostic), f32 out."""

    def __init__(self, in_features: int, num_classes: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, FC_DIM, dtype)
        self.fc2 = Dense(FC_DIM, FC_DIM, dtype)
        self.cls_score = Dense(FC_DIM, num_classes + 1, dtype)
        self.bbox_pred = Dense(FC_DIM, 4, dtype)

    def forward(self, pooled: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.relu(self.fc1(pooled.reshape(pooled.shape[0], -1)))      # channels-last flatten, as flax
        x = torch.relu(self.fc2(x))
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class CascadeROIHeads(nn.Module):
    """``stage0..2`` on FPN features of ``in_channels``, each pooling 7 x 7
    from p2-p5 as StandardROIHeads does."""

    def __init__(self, in_channels: int = 256, num_classes: int = 80, batch_per_image: int = 128,
                 pos_fraction: float = 0.25, dtype=torch.float32):
        super().__init__()
        self.num_classes, self.batch_per_image, self.pos_fraction = num_classes, batch_per_image, pos_fraction
        for i in range(len(STAGE_IOUS)):
            self.add_module(f"stage{i}", _CascadeBoxHead(POOLER_SIZE * POOLER_SIZE * in_channels, num_classes, dtype))
        self.transforms = [Box2BoxTransform(w) for w in STAGE_WEIGHTS]

    def _stage(self, k: int, features: Dict[str, torch.Tensor], rois: torch.Tensor):
        """Stage k on rois [B, R, 4]: class logits [B, R, C + 1] and deltas [B, R, 4]."""
        b, r = rois.shape[:2]
        cls_logits, deltas = getattr(self, f"stage{k}")(rcnn.pool_rois(features, rois, POOLER_SIZE, POOLER_LEVELS))
        return cls_logits.reshape(b, r, -1), deltas.reshape(b, r, 4)

    def _refine(self, k: int, deltas: torch.Tensor, rois: torch.Tensor, image_sizes: torch.Tensor) -> torch.Tensor:
        """Stage k's boxes: its deltas applied to its rois, clipped to each image."""
        sizes = image_sizes.to(rois.dtype)
        return rcnn.clip_boxes(self.transforms[k].apply_deltas(deltas, rois), (sizes[:, 0, None], sizes[:, 1, None]))

    def losses(self, features: Dict[str, torch.Tensor], proposals: torch.Tensor, image_sizes: torch.Tensor,
               targets: rcnn.DetTargets, generator=None) -> Dict[str, torch.Tensor]:
        """loss_cls_stage{k} and loss_box_reg_stage{k} of every stage."""
        losses: Dict[str, torch.Tensor] = {}
        c = self.num_classes
        rois = torch.cat([proposals, targets.boxes.to(proposals.dtype)], 1)
        for k, thr in enumerate(STAGE_IOUS):
            with torch.no_grad():
                matched_idx, labels = rcnn._match(targets, rois.detach(), (thr, thr), False)
                if k == 0:
                    n_pos = int(self.batch_per_image * self.pos_fraction)
                    fg, bg = labels == 1, labels == 0
                    fg_sel, bg_sel = rcnn._sample(fg, bg, n_pos, self.batch_per_image - n_pos, generator)
                    sel = torch.cat([fg_sel, bg_sel], 1)
                    fg_picked = fg.gather(1, fg_sel)
                    sel_fg = torch.cat([fg_picked, torch.zeros_like(bg_sel, dtype=torch.bool)], 1)
                    sel_valid = torch.cat([fg_picked, bg.gather(1, bg_sel)], 1)
                    matched_idx = matched_idx.gather(1, sel)
                else:                                   # later stages relabel without resampling
                    sel_fg, sel_valid = labels == 1, labels >= 0
                target_cls = torch.where(sel_fg, targets.labels.gather(1, matched_idx).long(), c)
                gt_boxes = targets.boxes.gather(1, matched_idx[..., None].expand(-1, -1, 4)).float()
            if k == 0:
                rois = rois.gather(1, sel[..., None].expand(-1, -1, 4))
            cls_logits, deltas = self._stage(k, features, rois)
            ce = -torch.log_softmax(cls_logits, -1)
            cls_loss = ce.gather(-1, target_cls[..., None])[..., 0]
            losses[f"loss_cls_stage{k}"] = (cls_loss * sel_valid).sum() / sel_valid.sum().clamp_min(1.0)
            diff = (deltas - self.transforms[k].get_deltas(rois, gt_boxes)).abs()
            losses[f"loss_box_reg_stage{k}"] = (diff.sum(-1) * sel_fg).sum() / sel_fg.sum().clamp_min(1.0)
            rois = self._refine(k, deltas.detach(), rois, image_sizes)
        return losses

    def inference(self, features: Dict[str, torch.Tensor], proposals: torch.Tensor,
                  image_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        """boxes [B, R, 4] (the last stage's) and scores [B, R, C] (the stages'
        softmaxes averaged, background dropped)."""
        rois, scores = proposals, 0
        for k in range(len(STAGE_IOUS)):
            cls_logits, deltas = self._stage(k, features, rois)
            scores = scores + torch.softmax(cls_logits, -1)
            rois = self._refine(k, deltas, rois, image_sizes)
        return {"boxes": rois, "scores": (scores / len(STAGE_IOUS))[..., :-1]}
