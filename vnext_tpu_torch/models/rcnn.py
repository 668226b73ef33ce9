"""GeneralizedRCNN serving: ResNet + FPN, the RPN, and the standard ROI box and
mask heads (Mask R-CNN, Faster R-CNN).

Counterpart of ``vnext_tpu.models.rcnn`` (reference surface:
detectron2/modeling/meta_arch/rcnn.py GeneralizedRCNN, proposal_generator/rpn.py,
roi_heads/roi_heads.py StandardROIHeads), inference only: training (RPN and
ROI sampling, the losses) is ROADMAP Queue 1 item 11b; Cascade and keypoint
R-CNN are item 11d. Module and parameter names follow the flax tree, so
``checkpoint/from_jax.py`` carries the JAX package's parameters across.

The JAX package's fixed shapes are kept, and with them its choices:

- proposals live in fixed-capacity slots: the RPN takes the top
  ``pre_nms_topk`` logits over all levels together (not per level, as
  detectron2), runs greedy NMS as a keep mask, and keeps the top
  ``post_nms_topk`` of the survivors' scores with the suppressed at -inf;
- detection takes the top 4 x ``max_detections`` of the flattened R x C class
  scores, class-aware NMS, then the top ``max_detections`` with the
  suppressed at -1 (``valid`` marks the kept);
- every top-k is a stable descending sort, so ties go to the lower index as
  ``jax.lax.top_k``'s do;
- the ROI pooler is 7 x 7 for the box head and the mask head alike, and the
  mask head's transposed convolution doubles it to 14 x 14 (detectron2 pools
  masks at 14 for 28 x 28): a kept divergence, ROADMAP Queue 3;
- layouts: the RPN's outputs are flattened in (y, x, anchor) order, the box
  head's input is the pooled [N, 7, 7, C] flattened channels-last, and the
  mask logits come out [B, R, m, m, C], as the JAX package's.

Convolutions run on NCHW (``channels_last`` memory on the card); the stem is
the hand-written kernel K2 when the model computes in bf16. NMS is
``ops/nms.py``'s sequential greedy loop, one device step per box.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..ops.nms import batched_nms_mask, nms_mask
from ..ops.roi_align import roi_align_levels
from ..structures.boxes import clip_boxes
from .backbones.fpn import FPN
from .backbones.resnet import ResNet
from .dense_heads import Box2BoxTransform, anchors_for_level, generate_cell_anchors
from .layers import Conv, ConvTranspose, Dense

TRAINING_ITEM = "R-CNN training is ROADMAP Queue 1, item 11b"


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of x's last axis and their indices, ties toward the lower
    index (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class RPN(nn.Module):
    """Region proposal network over the FPN levels (reference rpn.py:533)."""

    def __init__(self, in_channels: int = 256, num_anchors: int = 3, pre_nms_topk: int = 1000,
                 post_nms_topk: int = 512, nms_thresh: float = 0.7,
                 strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchor_sizes: Sequence[Sequence[float]] = ((32,), (64,), (128,), (256,), (512,)),
                 aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0), dtype=torch.float32):
        super().__init__()
        self.pre_nms_topk, self.post_nms_topk, self.nms_thresh = pre_nms_topk, post_nms_topk, nms_thresh
        self.strides = tuple(strides)
        self.cell_anchors = [generate_cell_anchors(s, aspect_ratios) for s in anchor_sizes]
        self.conv = Conv(in_channels, in_channels, 3, 1, 1, dtype=dtype)
        self.objectness = Conv(in_channels, num_anchors, 1, dtype=dtype)
        self.anchor_deltas = Conv(in_channels, num_anchors * 4, 1, dtype=dtype)
        self._anchors: Dict[tuple, torch.Tensor] = {}

    def anchors(self, shapes: Sequence[Tuple[int, int]], device) -> torch.Tensor:
        """[N, 4] anchors of every level, made once per level shapes and device."""
        key = (tuple(shapes), str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.cat([
                anchors_for_level(h, w, self.strides[lvl], self.cell_anchors[lvl], device)
                for lvl, (h, w) in enumerate(shapes)])
        return self._anchors[key]

    def forward(self, features: List[torch.Tensor], image_sizes: torch.Tensor):
        """features: NCHW maps, finest first; image_sizes [B, 2] (h, w). Returns
        (proposals [B, R, 4], proposal logits [B, R], anchors [N, 4], logits
        [B, N], deltas [B, N, 4]) with N over every level in (y, x, anchor) order."""
        logits_all, deltas_all = [], []
        for f in features:
            t = torch.relu(self.conv(f))
            b = f.shape[0]
            logits_all.append(self.objectness(t).permute(0, 2, 3, 1).reshape(b, -1))
            deltas_all.append(self.anchor_deltas(t).permute(0, 2, 3, 1).reshape(b, -1, 4))
        logits = torch.cat(logits_all, 1).float()
        deltas = torch.cat(deltas_all, 1).float()
        anchors = self.anchors([tuple(f.shape[-2:]) for f in features], logits.device)
        boxes = Box2BoxTransform().apply_deltas(deltas, anchors[None])
        pre_k = min(self.pre_nms_topk, logits.shape[1])
        proposals, prop_logits = [], []
        for lg, bx, hw in zip(logits, boxes, image_sizes):
            topv, topi = _topk_stable(lg, pre_k)
            cand = clip_boxes(bx[topi], (hw[0], hw[1]))
            keep = nms_mask(cand, topv, self.nms_thresh)
            outv, outi = _topk_stable(torch.where(keep, topv, torch.full_like(topv, -torch.inf)),
                                      self.post_nms_topk)
            proposals.append(cand[outi])
            prop_logits.append(outv)
        return torch.stack(proposals), torch.stack(prop_logits), anchors, logits, deltas


def assign_fpn_levels(rois: torch.Tensor, k0: int = 4, kmin: int = 2, kmax: int = 5) -> torch.Tensor:
    """Per-ROI FPN level (reference poolers.py:22 assign_boxes_to_levels)."""
    w = rois[..., 2] - rois[..., 0]
    h = rois[..., 3] - rois[..., 1]
    scale = torch.sqrt((w * h).clamp_min(1e-6))
    lvl = torch.floor(k0 + torch.log2(scale / 224.0 + 1e-8))
    return lvl.clamp(kmin, kmax).to(torch.int32)


class StandardROIHeads(nn.Module):
    """Box (+ optional mask) ROI heads (reference roi_heads.py:877) on FPN
    features of ``in_channels``: fc1 / fc2 / cls_score / bbox_pred, and
    mask_fcn1-4, mask_deconv, mask_pred on the same 7 x 7 pooled features."""

    def __init__(self, in_channels: int = 256, num_classes: int = 80, pooler_size: int = 7, fc_dim: int = 1024,
                 pooler_levels: Tuple[int, int] = (2, 5), mask_on: bool = False, keypoint_on: bool = False,
                 dtype=torch.float32):
        super().__init__()
        if keypoint_on:
            raise NotImplementedError("StandardROIHeads keypoint_on: keypoint R-CNN is not ported to "
                                      "vnext_tpu_torch yet (ROADMAP Queue 1, item 11d)")
        self.num_classes, self.pooler_size = num_classes, pooler_size
        self.pooler_levels, self.mask_on = tuple(pooler_levels), mask_on
        self.fc1 = Dense(pooler_size * pooler_size * in_channels, fc_dim, dtype)
        self.fc2 = Dense(fc_dim, fc_dim, dtype)
        self.cls_score = Dense(fc_dim, num_classes + 1, dtype)
        self.bbox_pred = Dense(fc_dim, num_classes * 4, dtype)
        if mask_on:
            for i in range(4):
                self.add_module(f"mask_fcn{i + 1}", Conv(in_channels if i == 0 else 256, 256, 3, 1, 1, dtype=dtype))
            self.mask_deconv = ConvTranspose(256, 256, 2, 2, dtype=dtype)
            self.mask_pred = Conv(256, num_classes, 1, dtype=dtype)

    def pool(self, features: Dict[str, torch.Tensor], rois: torch.Tensor) -> torch.Tensor:
        """[B * R, s, s, C] f32: each ROI pooled from its assigned level only."""
        b, r, _ = rois.shape
        lo, hi = self.pooler_levels
        lvl = assign_fpn_levels(rois, kmin=lo, kmax=hi).reshape(-1)
        batch = torch.arange(b, device=rois.device, dtype=torch.float32).repeat_interleave(r)[:, None]
        flat = torch.cat([batch, rois.reshape(-1, 4).float()], 1)
        return roi_align_levels([features[f"p{lv}"] for lv in range(lo, hi + 1)], flat, lvl - lo,
                                [2 ** lv for lv in range(lo, hi + 1)],
                                (self.pooler_size, self.pooler_size), sampling_ratio=2)

    def forward(self, features: Dict[str, torch.Tensor], rois: torch.Tensor) -> Dict[str, torch.Tensor]:
        """features {'p2'..'p5': NCHW}; rois [B, R, 4] absolute xyxy. Returns
        cls_logits [B, R, C + 1], box_deltas [B, R, 4C] (and mask_logits [B, R,
        m, m, C]), f32."""
        b, r, _ = rois.shape
        pooled = self.pool(features, rois)
        x = torch.relu(self.fc1(pooled.reshape(b * r, -1)))          # channels-last flatten, as flax
        x = torch.relu(self.fc2(x))
        out = {"cls_logits": self.cls_score(x).reshape(b, r, -1).float(),
               "box_deltas": self.bbox_pred(x).reshape(b, r, -1).float()}
        if self.mask_on:
            m = pooled.permute(0, 3, 1, 2)
            if m.is_cuda:
                m = m.contiguous(memory_format=torch.channels_last)
            for i in range(4):
                m = torch.relu(getattr(self, f"mask_fcn{i + 1}")(m))
            m = self.mask_pred(torch.relu(self.mask_deconv(m)))         # [B * R, C, m, m]
            out["mask_logits"] = m.permute(0, 2, 3, 1).reshape(b, r, *m.shape[2:], m.shape[1]).float()
        return out


class GeneralizedRCNN(nn.Module):
    """ResNet + FPN (p2-p6) + RPN + StandardROIHeads. ``inference`` takes
    normalized NHWC images [B, H, W, 3] and their true sizes [B, 2] and returns
    boxes [B, D, 4], scores [B, D], classes [B, D], valid [B, D] (and
    mask_probs [B, D, m, m] with ``mask_on``) for D = ``max_detections``."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50, fpn_channels: int = 256,
                 proposals_per_image: int = 512, mask_on: bool = False, keypoint_on: bool = False,
                 test_score_thresh: float = 0.05, test_nms_thresh: float = 0.5, max_detections: int = 100,
                 cascade_on: bool = False, dtype=torch.float32):
        super().__init__()
        if cascade_on:
            raise NotImplementedError("GeneralizedRCNN cascade_on (ROI_HEADS.NAME CascadeROIHeads): Cascade R-CNN "
                                      "is not ported to vnext_tpu_torch yet (ROADMAP Queue 1, item 11d)")
        if keypoint_on:
            raise NotImplementedError("GeneralizedRCNN keypoint_on (MODEL.KEYPOINT_ON): keypoint R-CNN is not "
                                      "ported to vnext_tpu_torch yet (ROADMAP Queue 1, item 11d)")
        self.num_classes, self.mask_on, self.dtype = num_classes, mask_on, dtype
        self.test_score_thresh, self.test_nms_thresh = test_score_thresh, test_nms_thresh
        self.max_detections = max_detections
        features = ("res2", "res3", "res4", "res5")
        self.backbone = ResNet(backbone_depth, dtype, out_features=features)
        self.fpn = FPN([self.backbone.output_channels[f] for f in features], features, fpn_channels,
                       top_block="maxpool", dtype=dtype)
        self.rpn = RPN(fpn_channels, post_nms_topk=proposals_per_image, dtype=dtype)
        self.roi_heads = StandardROIHeads(fpn_channels, num_classes, mask_on=mask_on, dtype=dtype)
        self.box2box = Box2BoxTransform(weights=(10.0, 10.0, 5.0, 5.0))

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``inference`` in eval mode; training raises (item 11b)."""
        if self.training:
            raise NotImplementedError(f"GeneralizedRCNN in train mode: {TRAINING_ITEM}")
        return self.inference(images, image_sizes)

    def _features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.fpn(self.backbone(images))

    def inference(self, images: torch.Tensor, image_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.inference_on_features(self._features(images), image_sizes)

    def detections(self, proposals: torch.Tensor, probs: torch.Tensor, box_deltas: torch.Tensor,
                   image_sizes: torch.Tensor):
        """fast_rcnn_inference with fixed shapes (reference fast_rcnn.py:462):
        every (proposal, class) pair is a candidate; per image the top 4D of the
        flattened scores, class-aware NMS, the top D. Returns boxes, scores,
        classes, valid and each detection's proposal index, each [B, D(, 4)]."""
        outs = []
        for prop, pr, bd, hw in zip(proposals, probs, box_deltas, image_sizes):
            r, c = pr.shape
            k = min(4 * self.max_detections, r * c)
            top_sc, top_idx = _topk_stable(pr.reshape(-1), k)
            pi, cls = top_idx // c, top_idx % c
            boxes = clip_boxes(self.box2box.apply_deltas(bd[pi, cls], prop[pi]), (hw[0], hw[1]))
            keep = batched_nms_mask(boxes, top_sc, cls, self.test_nms_thresh, valid=top_sc > self.test_score_thresh)
            outv, outi = _topk_stable(torch.where(keep, top_sc, torch.full_like(top_sc, -1.0)), self.max_detections)
            outs.append((boxes[outi], outv, cls[outi], outv > 0, pi[outi]))
        return [torch.stack(t) for t in zip(*outs)]

    def inference_on_features(self, feats: Dict[str, torch.Tensor],
                              image_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        proposals = self.rpn([feats[f"p{i}"] for i in range(2, 7)], image_sizes)[0]
        head_out = self.roi_heads(feats, proposals)
        b, r = proposals.shape[:2]
        probs = torch.softmax(head_out["cls_logits"], -1)[..., :-1]
        box_deltas = head_out["box_deltas"].reshape(b, r, self.num_classes, 4)
        boxes, scores, classes, valid, det_idx = self.detections(proposals, probs, box_deltas, image_sizes)
        out = {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid}
        if self.mask_on:
            out["mask_probs"] = torch.sigmoid(self._class_masks(head_out["mask_logits"], det_idx, classes))
        return out

    def _class_masks(self, mask_logits: torch.Tensor, det_idx: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
        """mask_logits [B, R, m, m, C] at each detection's ROI and class: [B, D, m, m]."""
        per_det = torch.stack([ml[i] for ml, i in zip(mask_logits, det_idx)])     # [B, D, m, m, C]
        cls = classes.clamp(0, self.num_classes - 1)[:, :, None, None, None].expand(*per_det.shape[:4], 1)
        return per_det.gather(-1, cls)[..., 0]

    def inference_masks_on_boxes(self, images: torch.Tensor, boxes: torch.Tensor,
                                 classes: torch.Tensor) -> torch.Tensor:
        """The mask branch alone on given boxes [B, D, 4] and classes [B, D]
        (the second pass of test-time augmentation): mask probs [B, D, m, m]."""
        ml = self.roi_heads(self._features(images), boxes)["mask_logits"]
        idx = torch.arange(boxes.shape[1], device=boxes.device).expand(boxes.shape[0], -1)
        return torch.sigmoid(self._class_masks(ml, idx, classes))
