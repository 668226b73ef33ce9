"""ROI heads beyond the standard ones: the C4 head, the keypoint head and the
rotated-box heads.

Counterpart of ``vnext_tpu.models.roi_heads_extra`` (reference surface:
detectron2/modeling/roi_heads/):

- roi_heads.py:430 ``Res5ROIHeads``, the C4 layout: 14x14 ROIs pooled from
  res4 at stride 16, the res5 stage (three bottlenecks, the first at stride 2)
  as the shared head, mean pooling for the box predictor; with ``mask_on`` a
  2x2 / 2 transposed convolution and a 1x1 predictor on the res5 map;
- keypoint_head.py ``KRCNNConvDeconvUpsampleHead``, ``keypoint_rcnn_loss``,
  ``keypoint_rcnn_inference``;
- rotated_fast_rcnn.py ``RROIHeads``: (cx, cy, w, h, angle) ROIs pooled by
  ``roi_align_rotated``, two fc layers, class-agnostic 5-d deltas of
  ``Box2BoxTransformRotated``, the rotated NMS at inference and, in
  ``losses``, rotated-IoU matching with L1 deltas and no ROI sampler, as in
  the JAX package.

The heads take the port's NCHW feature maps (the JAX package's are NHWC) and
return the JAX package's channels-last outputs.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..ops.interpolate import resize_bilinear
from ..ops.roi_align import roi_align
from ..ops.roi_align_rotated import roi_align_rotated
from ..ops.rotated_boxes import nms_rotated_mask, pairwise_iou_rotated
from ..parallel.mesh import global_count
from ..structures.keypoints import Keypoints
from .backbones.resnet import Bottleneck
from .layers import Conv, ConvTranspose, Dense


def _batched_rois(rois: torch.Tensor) -> torch.Tensor:
    """[B, R, D] -> [B * R, 1 + D] with each ROI's batch index in front."""
    b, r, d = rois.shape
    col = torch.arange(b, device=rois.device, dtype=torch.float32).repeat_interleave(r)[:, None]
    return torch.cat([col, rois.reshape(-1, d).float()], 1)


class Res5ROIHeads(nn.Module):
    """The C4 heads: pool [14x14] from res4 (stride 16), run res5 (3
    bottlenecks, the first at stride 2) as the shared head, mean-pool for the
    box predictor; the mask head takes the res5 map."""

    def __init__(self, num_classes: int = 80, pooler_size: int = 14, mask_on: bool = False, dtype=torch.float32,
                 in_channels: int = 1024):
        super().__init__()
        self.num_classes, self.pooler_size, self.mask_on, self.dtype = num_classes, pooler_size, mask_on, dtype
        for i in range(3):
            self.add_module(f"res5_{i}", Bottleneck(in_channels if i == 0 else 2048, 512, 2048, 2 if i == 0 else 1,
                                                    dtype))
        self.cls_score = Dense(2048, num_classes + 1, dtype)
        self.bbox_pred = Dense(2048, num_classes * 4, dtype)
        if mask_on:
            self.mask_deconv = ConvTranspose(2048, 256, 2, 2, dtype=dtype)
            self.mask_pred = Conv(256, num_classes, 1, dtype=dtype)

    def forward(self, res4: torch.Tensor, rois: torch.Tensor) -> Dict[str, torch.Tensor]:
        """res4 [B, C, H, W]; rois [B, R, 4] absolute xyxy. Returns cls_logits
        [B, R, C + 1], box_deltas [B, R, 4C] and with ``mask_on`` mask_logits
        [B, R, 14, 14, C], all f32."""
        b, r, _ = rois.shape
        pooled = roi_align(res4, _batched_rois(rois), (self.pooler_size, self.pooler_size),
                           spatial_scale=1.0 / 16, sampling_ratio=2)
        x = pooled.permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        for i in range(3):
            x = getattr(self, f"res5_{i}")(x)                        # [B * R, 2048, 7, 7]
        feat = x.mean(dim=(2, 3))
        out = {"cls_logits": self.cls_score(feat).reshape(b, r, -1).float(),
               "box_deltas": self.bbox_pred(feat).reshape(b, r, -1).float()}
        if self.mask_on:
            m = self.mask_pred(torch.relu(self.mask_deconv(x)))
            out["mask_logits"] = m.permute(0, 2, 3, 1).reshape(b, r, *m.shape[2:], m.shape[1]).float()
        return out


# the keypoint head's convolutions, as the JAX package's GeneralizedRCNN builds it (the reference has 8 of
# 512; a kept divergence, ROADMAP Queue 3 item 5)
CONV_DIMS = (256,) * 4


class KRCNNConvDeconvUpsampleHead(nn.Module):
    """``conv_fcn1..4`` (3x3, ReLU), ``score_lowres`` (a 4x4 stride-2
    transposed convolution at flax's "SAME") and a x2 bilinear resize:
    pooled [N, s, s, C] channels-last -> heatmap logits [N, 4s, 4s, K], f32."""

    def __init__(self, in_channels: int = 256, num_keypoints: int = 17, dtype=torch.float32):
        super().__init__()
        self.num_convs = len(CONV_DIMS)
        dims = [in_channels, *CONV_DIMS]
        for i in range(self.num_convs):
            self.add_module(f"conv_fcn{i + 1}", Conv(dims[i], dims[i + 1], 3, 1, 1, dtype=dtype))
        self.score_lowres = ConvTranspose(dims[-1], num_keypoints, 4, 2, dtype=dtype)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        for i in range(self.num_convs):
            x = torch.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        x = self.score_lowres(x)
        x = resize_bilinear(x, 2 * x.shape[-2], 2 * x.shape[-1])
        return x.permute(0, 2, 3, 1).float()


def keypoint_rcnn_loss(heatmap_logits: torch.Tensor, keypoints: torch.Tensor, rois: torch.Tensor,
                       fg_mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over each visible keypoint's S x S grid, averaged over the
    visible keypoints of the foreground ROIs. heatmap_logits [N, S, S, K];
    keypoints [N, K, 3] absolute (x, y, vis); rois [N, 4]; fg_mask [N]."""
    n, s, _, k = heatmap_logits.shape
    idx, valid = Keypoints(keypoints).to_heatmap(rois, heatmap_size=s)
    logp = torch.log_softmax(heatmap_logits.permute(0, 3, 1, 2).reshape(n, k, s * s), -1)
    ce = -logp.gather(-1, idx.clamp(0, s * s - 1)[..., None])[..., 0]
    w = valid.float() * fg_mask[:, None].float()
    return (ce * w).sum() / global_count(w.sum())


def keypoint_rcnn_inference(heatmap_logits: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """[N, K, 3] (x, y, score) decoded from per-ROI heatmaps."""
    return Keypoints.from_heatmap(heatmap_logits, rois)


class Box2BoxTransformRotated:
    """(dx, dy, dw, dh, da) deltas of (cx, cy, w, h, angle_deg) boxes
    (reference box_regression.py Box2BoxTransformRotated); angles wrap into
    [-180, 180) by ``(a + 180) mod 360 - 180``, the floored modulo."""

    def __init__(self, weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0, 1.0),
                 scale_clamp: float = math.log(1000.0 / 16)):
        self.weights = weights
        self.scale_clamp = scale_clamp

    def get_deltas(self, src: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        wx, wy, ww, wh, wa = self.weights
        dx = wx * (target[..., 0] - src[..., 0]) / src[..., 2].clamp_min(1e-6)
        dy = wy * (target[..., 1] - src[..., 1]) / src[..., 3].clamp_min(1e-6)
        dw = ww * torch.log(target[..., 2].clamp_min(1e-6) / src[..., 2].clamp_min(1e-6))
        dh = wh * torch.log(target[..., 3].clamp_min(1e-6) / src[..., 3].clamp_min(1e-6))
        da_deg = torch.remainder(target[..., 4] - src[..., 4] + 180.0, 360.0) - 180.0
        da = wa * da_deg * math.pi / 180.0
        return torch.stack([dx, dy, dw, dh, da], -1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        wx, wy, ww, wh, wa = self.weights
        cx = boxes[..., 0] + deltas[..., 0] / wx * boxes[..., 2]
        cy = boxes[..., 1] + deltas[..., 1] / wy * boxes[..., 3]
        w = boxes[..., 2] * torch.exp((deltas[..., 2] / ww).clamp(-self.scale_clamp, self.scale_clamp))
        h = boxes[..., 3] * torch.exp((deltas[..., 3] / wh).clamp(-self.scale_clamp, self.scale_clamp))
        a = boxes[..., 4] + deltas[..., 4] / wa * 180.0 / math.pi
        a = torch.remainder(a + 180.0, 360.0) - 180.0
        return torch.stack([cx, cy, w, h, a], -1)


class RROIHeads(nn.Module):
    """Rotated-box ROI heads: ``roi_align_rotated`` pooling, fc1 / fc2 (ReLU),
    ``cls_score`` and the class-agnostic 5-d ``bbox_pred``."""

    def __init__(self, num_classes: int = 10, pooler_size: int = 7, fc_dim: int = 1024, test_nms_thresh: float = 0.3,
                 test_score_thresh: float = 0.05, max_detections: int = 100, dtype=torch.float32,
                 in_channels: int = 1024):
        super().__init__()
        self.num_classes, self.pooler_size, self.dtype = num_classes, pooler_size, dtype
        self.test_nms_thresh, self.test_score_thresh, self.max_detections = (test_nms_thresh, test_score_thresh,
                                                                             max_detections)
        self.fc1 = Dense(pooler_size * pooler_size * in_channels, fc_dim, dtype)
        self.fc2 = Dense(fc_dim, fc_dim, dtype)
        self.cls_score = Dense(fc_dim, num_classes + 1, dtype)
        self.bbox_pred = Dense(fc_dim, 5, dtype)

    def forward(self, features: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
                train: bool = True) -> Dict[str, torch.Tensor]:
        """features [B, C, H, W], one level; rois [B, R, 5] (cx, cy, w, h, a).
        Returns cls_logits [B, R, C + 1] and box_deltas [B, R, 5] (f32); with
        ``train`` False also the detections: boxes [B, D, 5], scores, classes
        and valid [B, D], D = min(max_detections, R)."""
        b, r, _ = rois.shape
        pooled = roi_align_rotated(features, _batched_rois(rois), (self.pooler_size, self.pooler_size),
                                   spatial_scale=spatial_scale, sampling_ratio=2)
        x = torch.relu(self.fc1(pooled.reshape(b * r, -1)))
        x = torch.relu(self.fc2(x))
        out = {"cls_logits": self.cls_score(x).reshape(b, r, -1).float(),
               "box_deltas": self.bbox_pred(x).reshape(b, r, 5).float()}
        if not train:
            out.update(self.inference(out["cls_logits"], out["box_deltas"], rois))
        return out

    def inference(self, cls_logits: torch.Tensor, box_deltas: torch.Tensor,
                  rois: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per image: each ROI's best class over the score threshold, rotated
        NMS over those, the top ``max_detections`` of the kept scores (ties
        toward the lower index, as ``lax.top_k``)."""
        boxes = Box2BoxTransformRotated().apply_deltas(box_deltas, rois.float())
        probs = torch.softmax(cls_logits, -1)[..., :-1]
        outs = []
        for bx, pr in zip(boxes, probs):
            best, cls = pr.amax(-1), pr.argmax(-1)        # ties: the first class, as jnp.argmax
            keep = nms_rotated_mask(bx, best, self.test_nms_thresh, valid=best > self.test_score_thresh)
            sc = torch.where(keep, best, torch.full_like(best, -1.0))
            outv, outi = torch.sort(sc, descending=True, stable=True)
            k = min(self.max_detections, bx.shape[0])
            outv, outi = outv[:k], outi[:k]
            outs.append((bx[outi], outv, cls[outi], outv > 0))
        return dict(zip(("boxes", "scores", "classes", "valid"), (torch.stack(t) for t in zip(*outs))))

    @staticmethod
    def losses(cls_logits: torch.Tensor, box_deltas: torch.Tensor, rois: torch.Tensor, gt_boxes: torch.Tensor,
               gt_labels: torch.Tensor, gt_valid: torch.Tensor, num_classes: int,
               iou_thresh: float = 0.5) -> Dict[str, torch.Tensor]:
        """Each ROI matched to its highest rotated-IoU valid ground truth
        (foreground at ``iou_thresh`` or more); the cross-entropy over every
        ROI and the L1 of the 5-d deltas over the foreground."""
        matched, fg = [], []
        for rb, gb, gv in zip(rois, gt_boxes, gt_valid):
            iou = torch.where(gv[None, :], pairwise_iou_rotated(rb, gb), torch.full((), -1.0, device=rb.device))
            matched.append(iou.argmax(1))
            fg.append(iou.amax(1) >= iou_thresh)
        matched, fg = torch.stack(matched), torch.stack(fg)
        gt_cls = gt_labels.long().gather(1, matched)
        target_cls = torch.where(fg, gt_cls, torch.full_like(gt_cls, num_classes))
        cls_loss = -torch.log_softmax(cls_logits, -1).gather(-1, target_cls[..., None])[..., 0]
        matched_boxes = gt_boxes.float().gather(1, matched[..., None].expand(-1, -1, 5))
        gt_deltas = Box2BoxTransformRotated().get_deltas(rois.float(), matched_boxes)
        reg = (box_deltas - gt_deltas).abs().sum(-1)
        n_fg = global_count(fg.sum())
        return {"loss_cls_rotated": cls_loss.mean(), "loss_box_reg_rotated": (reg * fg).sum() / n_fg}
