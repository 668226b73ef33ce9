"""GeneralizedRCNN (Mask R-CNN, Faster R-CNN, keypoint R-CNN, Cascade R-CNN)
and ProposalNetwork: ResNet + FPN, the RPN, and the standard ROI box, mask and
keypoint heads or the cascade's (``models/cascade_rcnn.py``), serving and
training.

Counterpart of ``vnext_tpu.models.rcnn`` (reference surface:
detectron2/modeling/meta_arch/rcnn.py GeneralizedRCNN and ProposalNetwork,
proposal_generator/rpn.py, roi_heads/roi_heads.py StandardROIHeads,
keypoint_head.py, cascade_rcnn.py); PanopticFPN is ROADMAP Queue 1 item 11d.
Module and parameter names follow the flax tree, so ``checkpoint/from_jax.py``
carries the JAX package's parameters across.

The JAX package's fixed shapes are kept, and with them its choices:

- proposals live in fixed-capacity slots: the RPN takes the top
  ``pre_nms_topk_train`` (2000) or ``pre_nms_topk_test`` (1000) logits over
  all levels together (not per level, as detectron2), runs greedy NMS as a
  keep mask, and keeps the top ``post_nms_topk`` of the survivors' scores with
  the suppressed at -inf; boxes of zero side are kept (detectron2 drops them);
- detection takes the top 4 x ``max_detections`` of the flattened R x C class
  scores, class-aware NMS, then the top ``max_detections`` with the
  suppressed at -1 (``valid`` marks the kept);
- every top-k is a stable descending sort, so ties go to the lower index as
  ``jax.lax.top_k``'s do;
- the ROI pooler is 7 x 7 for the box head and the mask head alike, and the
  mask head's transposed convolution doubles it to 14 x 14 (detectron2 pools
  masks at 14 for 28 x 28); the keypoint head (4 convolutions of 256, where
  detectron2 has 8 of 512) takes the same 7 x 7 features to 28 x 28 heatmaps
  (detectron2: 14 x 14 to 56 x 56): kept divergences, ROADMAP Queue 3;
- the cascade is box-only (with ``mask_on`` or ``keypoint_on`` it raises, as
  JAX's asserts); its detections are its last stage's boxes, clipped, under
  the stages' averaged scores;
- layouts: the RPN's outputs are flattened in (y, x, anchor) order, the box
  head's input is the pooled [N, 7, 7, C] flattened channels-last, and the
  mask logits come out [B, R, m, m, C], as the JAX package's.

Training samples in fixed shapes too: 256 anchors per image at half
foreground for the RPN, ``roi_batch_per_image`` ROIs at ``roi_pos_fraction``
from the proposals and the ground-truth slots for the heads, each the top-k
of uniform priorities among the members of a class (non-members at -1). The
priorities come from ``sampling_priorities`` (the step's generator; JAX draws
from its key, so the bits differ and tests replace this function). As in
JAX, the proposals are not detached: the ROI losses reach the RPN's deltas
through the pooler's bilinear weights and the box targets.

Convolutions run on NCHW (``channels_last`` memory on the card); the stem is
the hand-written kernel K2 when the model computes in bf16. NMS is
``ops/nms.py``'s sequential greedy loop, one device step per box.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.losses import sigmoid_bce_with_logits
from ..ops.nms import batched_nms_mask, nms_mask
from ..ops.roi_align import roi_align_levels, roi_align_per_item
from ..structures.boxes import clip_boxes
from .backbones.fpn import FPN
from .backbones.resnet import ResNet
from .dense_heads import Box2BoxTransform, anchors_for_level, generate_cell_anchors, iou_matcher
from .layers import Conv, ConvTranspose, Dense
from .roi_heads_extra import KRCNNConvDeconvUpsampleHead, keypoint_rcnn_inference, keypoint_rcnn_loss


class DetTargets(NamedTuple):
    """Padded ground truth of a batch: labels [B, K], boxes [B, K, 4] absolute
    xyxy, valid [B, K] (the JAX package's ``models.retinanet.DetTargets``)."""

    labels: torch.Tensor
    boxes: torch.Tensor
    valid: torch.Tensor


def _topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of x's last axis and their indices, ties toward the lower
    index (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def sampling_priorities(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Uniform [0, 1) priorities of a fixed-shape foreground / background
    sample (JAX: ``jax.random.uniform`` of the step's key), drawn from the
    step's generator."""
    return torch.rand(shape, generator=generator, device=device)


def _sample(fg: torch.Tensor, bg: torch.Tensor, n_pos: int, n_neg: int, generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices [B, n_pos] and [B, n_neg] of the top priorities among ``fg``'s
    and ``bg``'s members ([B, N] bool); where a class has too few members the
    rest are non-members (priority -1, the lower index first)."""
    pri = sampling_priorities(fg.shape, generator, fg.device)
    fg_sel = _topk_stable(torch.where(fg, pri, -1.0), n_pos)[1]
    bg_sel = _topk_stable(torch.where(bg, pri, -1.0), n_neg)[1]
    return fg_sel, bg_sel


def _match(gt: DetTargets, boxes: torch.Tensor, thresholds, low_quality: bool):
    """``iou_matcher`` per image: (matched ground-truth slot [B, N], label [B, N])
    of ``boxes`` [N, 4] (every image's) or [B, N, 4]."""
    per_image = boxes.expand(gt.boxes.shape[0], *boxes.shape[-2:]) if boxes.dim() == 2 else boxes
    out = [iou_matcher(g, v, b, thresholds, low_quality) for g, v, b in zip(gt.boxes, gt.valid, per_image)]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


class RPN(nn.Module):
    """Region proposal network over the FPN levels (reference rpn.py:533)."""

    def __init__(self, in_channels: int = 256, num_anchors: int = 3, pre_nms_topk_train: int = 2000,
                 pre_nms_topk_test: int = 1000, post_nms_topk: int = 512, nms_thresh: float = 0.7,
                 strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchor_sizes: Sequence[Sequence[float]] = ((32,), (64,), (128,), (256,), (512,)),
                 aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0), dtype=torch.float32):
        super().__init__()
        self.pre_nms_topk_train, self.pre_nms_topk_test = pre_nms_topk_train, pre_nms_topk_test
        self.post_nms_topk, self.nms_thresh = post_nms_topk, nms_thresh
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

    def forward(self, features: List[torch.Tensor], image_sizes: torch.Tensor, train: bool = False):
        """features: NCHW maps, finest first; image_sizes [B, 2] (h, w). Returns
        (proposals [B, R, 4], proposal logits [B, R], anchors [N, 4], logits
        [B, N], deltas [B, N, 4]) with N over every level in (y, x, anchor)
        order. ``train`` takes the training pre-NMS top-k; the proposals stay
        differentiable in the deltas either way."""
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
        pre_k = min(self.pre_nms_topk_train if train else self.pre_nms_topk_test, logits.shape[1])
        proposals, prop_logits = [], []
        for lg, bx, hw in zip(logits, boxes, image_sizes):
            topv, topi = _topk_stable(lg, pre_k)
            cand = clip_boxes(bx[topi], (hw[0], hw[1]))
            keep = nms_mask(cand.detach(), topv.detach(), self.nms_thresh)
            outv, outi = _topk_stable(torch.where(keep, topv, torch.full_like(topv, -torch.inf)),
                                      self.post_nms_topk)
            proposals.append(cand[outi])
            prop_logits.append(outv)
        return torch.stack(proposals), torch.stack(prop_logits), anchors, logits, deltas

    @staticmethod
    def losses(logits: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor, targets: DetTargets,
               generator: Optional[torch.Generator] = None, pos_fraction: float = 0.5,
               batch_per_image: int = 256) -> Dict[str, torch.Tensor]:
        """Objectness BCE and L1 on the deltas of ``batch_per_image`` anchors per
        image sampled at ``pos_fraction`` foreground, the anchors matched at
        (0.3, 0.7) with low-quality matches; both divided by batch_per_image x
        B (reference rpn.py:421-426)."""
        with torch.no_grad():
            matched_idx, labels = _match(targets, anchors, (0.3, 0.7), True)
            n_pos = int(batch_per_image * pos_fraction)
            fg, bg = labels == 1, labels == 0
            fg_sel, bg_sel = _sample(fg, bg, n_pos, batch_per_image - n_pos, generator)
            fg_mask, bg_mask = fg.gather(1, fg_sel), bg.gather(1, bg_sel)
            gt_boxes = targets.boxes.gather(1, matched_idx.gather(1, fg_sel)[..., None].expand(-1, -1, 4))
            gt_deltas = Box2BoxTransform().get_deltas(anchors[fg_sel], gt_boxes.float())
        lg_fg, lg_bg = logits.gather(1, fg_sel), logits.gather(1, bg_sel)
        obj_loss = ((sigmoid_bce_with_logits(lg_fg, torch.ones_like(lg_fg)) * fg_mask).sum()
                    + (sigmoid_bce_with_logits(lg_bg, torch.zeros_like(lg_bg)) * bg_mask).sum())
        diff = (deltas.gather(1, fg_sel[..., None].expand(-1, -1, 4)) - gt_deltas).abs()
        loc_loss = (diff.sum(-1) * fg_mask).sum()
        norm = float(batch_per_image) * fg.shape[0]
        return {"loss_rpn_cls": obj_loss / norm, "loss_rpn_loc": loc_loss / norm}


def assign_fpn_levels(rois: torch.Tensor, k0: int = 4, kmin: int = 2, kmax: int = 5) -> torch.Tensor:
    """Per-ROI FPN level (reference poolers.py:22 assign_boxes_to_levels)."""
    w = rois[..., 2] - rois[..., 0]
    h = rois[..., 3] - rois[..., 1]
    scale = torch.sqrt((w * h).clamp_min(1e-6))
    lvl = torch.floor(k0 + torch.log2(scale / 224.0 + 1e-8))
    return lvl.clamp(kmin, kmax).to(torch.int32)


def pool_rois(features: Dict[str, torch.Tensor], rois: torch.Tensor, pooler_size: int,
              pooler_levels: Tuple[int, int]) -> torch.Tensor:
    """[B * R, s, s, C] f32 of rois [B, R, 4]: each ROI pooled from its
    assigned FPN level only."""
    b, r, _ = rois.shape
    lo, hi = pooler_levels
    lvl = assign_fpn_levels(rois, kmin=lo, kmax=hi).reshape(-1)
    batch = torch.arange(b, device=rois.device, dtype=torch.float32).repeat_interleave(r)[:, None]
    flat = torch.cat([batch, rois.reshape(-1, 4).float()], 1)
    return roi_align_levels([features[f"p{lv}"] for lv in range(lo, hi + 1)], flat, lvl - lo,
                            [2 ** lv for lv in range(lo, hi + 1)], (pooler_size, pooler_size), sampling_ratio=2)


def _trunk(backbone_depth: int, fpn_channels: int, proposals_per_image: int, dtype):
    """ResNet (res2-res5), FPN (p2-p6, the max-pool top block) and the RPN."""
    features = ("res2", "res3", "res4", "res5")
    backbone = ResNet(backbone_depth, dtype, out_features=features)
    fpn = FPN([backbone.output_channels[f] for f in features], features, fpn_channels, top_block="maxpool",
              dtype=dtype)
    return backbone, fpn, RPN(fpn_channels, post_nms_topk=proposals_per_image, dtype=dtype)


class StandardROIHeads(nn.Module):
    """Box (+ optional mask and keypoint) ROI heads (reference
    roi_heads.py:877) on FPN features of ``in_channels``: fc1 / fc2 /
    cls_score / bbox_pred, mask_fcn1-4, mask_deconv, mask_pred and
    keypoint_head, all on the same 7 x 7 pooled features."""

    def __init__(self, in_channels: int = 256, num_classes: int = 80, pooler_size: int = 7, fc_dim: int = 1024,
                 pooler_levels: Tuple[int, int] = (2, 5), mask_on: bool = False, keypoint_on: bool = False,
                 num_keypoints: int = 17, dtype=torch.float32):
        super().__init__()
        self.num_classes, self.pooler_size = num_classes, pooler_size
        self.pooler_levels, self.mask_on, self.keypoint_on = tuple(pooler_levels), mask_on, keypoint_on
        self.fc1 = Dense(pooler_size * pooler_size * in_channels, fc_dim, dtype)
        self.fc2 = Dense(fc_dim, fc_dim, dtype)
        self.cls_score = Dense(fc_dim, num_classes + 1, dtype)
        self.bbox_pred = Dense(fc_dim, num_classes * 4, dtype)
        if mask_on:
            for i in range(4):
                self.add_module(f"mask_fcn{i + 1}", Conv(in_channels if i == 0 else 256, 256, 3, 1, 1, dtype=dtype))
            self.mask_deconv = ConvTranspose(256, 256, 2, 2, dtype=dtype)
            self.mask_pred = Conv(256, num_classes, 1, dtype=dtype)
        if keypoint_on:
            self.keypoint_head = KRCNNConvDeconvUpsampleHead(in_channels, num_keypoints, dtype)

    def pool(self, features: Dict[str, torch.Tensor], rois: torch.Tensor) -> torch.Tensor:
        return pool_rois(features, rois, self.pooler_size, self.pooler_levels)

    def forward(self, features: Dict[str, torch.Tensor], rois: torch.Tensor) -> Dict[str, torch.Tensor]:
        """features {'p2'..'p5': NCHW}; rois [B, R, 4] absolute xyxy. Returns
        cls_logits [B, R, C + 1], box_deltas [B, R, 4C] (and mask_logits [B, R,
        m, m, C], keypoint_logits [B, R, 4s, 4s, K]), f32."""
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
        if self.keypoint_on:
            kp = self.keypoint_head(pooled)
            out["keypoint_logits"] = kp.reshape(b, r, *kp.shape[1:])
        return out


class GeneralizedRCNN(nn.Module):
    """ResNet + FPN (p2-p6) + RPN + StandardROIHeads (or, with ``cascade_on``,
    CascadeROIHeads). ``inference`` takes normalized NHWC images [B, H, W, 3]
    and their true sizes [B, 2] and returns boxes [B, D, 4], scores [B, D],
    classes [B, D], valid [B, D] (and mask_probs [B, D, m, m] with
    ``mask_on``, keypoints [B, D, K, 3] (x, y, score) with ``keypoint_on``)
    for D = ``max_detections``; in train mode ``forward`` returns the loss
    dict."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50, fpn_channels: int = 256,
                 proposals_per_image: int = 512, roi_batch_per_image: int = 128, roi_pos_fraction: float = 0.25,
                 mask_on: bool = False, keypoint_on: bool = False, num_keypoints: int = 17,
                 test_score_thresh: float = 0.05, test_nms_thresh: float = 0.5, max_detections: int = 100,
                 cascade_on: bool = False, dtype=torch.float32):
        super().__init__()
        self.num_classes, self.mask_on, self.keypoint_on, self.dtype = num_classes, mask_on, keypoint_on, dtype
        self.cascade_on = cascade_on
        self.roi_batch_per_image, self.roi_pos_fraction = roi_batch_per_image, roi_pos_fraction
        self.test_score_thresh, self.test_nms_thresh = test_score_thresh, test_nms_thresh
        self.max_detections = max_detections
        self.backbone, self.fpn, self.rpn = _trunk(backbone_depth, fpn_channels, proposals_per_image, dtype)
        if cascade_on:
            if mask_on or keypoint_on:
                raise ValueError("GeneralizedRCNN cascade_on: the cascade is box-only, as the JAX package's "
                                 "(MODEL.MASK_ON and MODEL.KEYPOINT_ON must be False); use "
                                 "inference_masks_on_boxes of a Mask R-CNN for masks on its final boxes")
            from .cascade_rcnn import CascadeROIHeads

            self.roi_heads = CascadeROIHeads(fpn_channels, num_classes, batch_per_image=roi_batch_per_image,
                                             pos_fraction=roi_pos_fraction, dtype=dtype)
        else:
            self.roi_heads = StandardROIHeads(fpn_channels, num_classes, mask_on=mask_on, keypoint_on=keypoint_on,
                                              num_keypoints=num_keypoints, dtype=dtype)
        self.box2box = Box2BoxTransform(weights=(10.0, 10.0, 5.0, 5.0))

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor, targets: Optional[DetTargets] = None,
                gt_masks: Optional[torch.Tensor] = None, gt_keypoints: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``inference`` in eval mode; in train mode the losses of ``targets``
        (and ``gt_masks`` [B, K, H, W], any dtype, with ``mask_on``;
        ``gt_keypoints`` [B, K, num_keypoints, 3] absolute (x, y, visibility)
        with ``keypoint_on``), the samples drawn from ``generator``."""
        if not self.training:
            return self.inference(images, image_sizes)
        return self.losses_on_features(self._features(images), image_sizes, targets, gt_masks, generator,
                                       gt_keypoints)

    def losses_on_features(self, feats: Dict[str, torch.Tensor], image_sizes: torch.Tensor, targets: DetTargets,
                           gt_masks: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                           gt_keypoints: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """loss_rpn_cls, loss_rpn_loc, loss_cls, loss_box_reg (and loss_mask,
        loss_keypoint): the RPN's, then the heads' on a fixed ROI batch sampled
        from the proposals and the ground-truth slots matched at IoU 0.5; with
        ``cascade_on`` the RPN's, then each stage's."""
        proposals, _, anchors, rpn_logits, rpn_deltas = self.rpn([feats[f"p{i}"] for i in range(2, 7)],
                                                                 image_sizes, train=True)
        losses = RPN.losses(rpn_logits, rpn_deltas, anchors, targets, generator)
        if self.cascade_on:
            losses.update(self.roi_heads.losses(feats, proposals, image_sizes, targets, generator))
            return losses
        b, c = proposals.shape[0], self.num_classes
        rois = torch.cat([proposals, targets.boxes.to(proposals.dtype)], 1)
        with torch.no_grad():
            matched_idx, labels = _match(targets, rois.detach(), (0.5, 0.5), False)
            n_pos = int(self.roi_batch_per_image * self.roi_pos_fraction)
            fg, bg = labels == 1, labels == 0
            fg_sel, bg_sel = _sample(fg, bg, n_pos, self.roi_batch_per_image - n_pos, generator)
            sel = torch.cat([fg_sel, bg_sel], 1)                                         # [B, Rb]
            fg_picked = fg.gather(1, fg_sel)
            sel_fg = torch.cat([fg_picked, torch.zeros_like(bg_sel, dtype=torch.bool)], 1)
            sel_valid = torch.cat([fg_picked, bg.gather(1, bg_sel)], 1)
            sel_gt_idx = matched_idx.gather(1, sel)
            gt_cls = targets.labels.gather(1, sel_gt_idx).long()
            target_cls = torch.where(sel_fg, gt_cls, c)                                  # background: the last class
            gt_boxes = targets.boxes.gather(1, sel_gt_idx[..., None].expand(-1, -1, 4)).float()
        sel_rois = rois.gather(1, sel[..., None].expand(-1, -1, 4))
        head_out = self.roi_heads(feats, sel_rois)

        ce = -torch.log_softmax(head_out["cls_logits"], -1)
        cls_loss = ce.gather(-1, target_cls[..., None])[..., 0]
        losses["loss_cls"] = (cls_loss * sel_valid).sum() / sel_valid.sum().clamp_min(1.0)
        n_fg = sel_fg.sum().clamp_min(1.0)
        gt_deltas = self.box2box.get_deltas(sel_rois, gt_boxes)
        rb = sel.shape[1]
        box_deltas = head_out["box_deltas"].reshape(b, rb, c, 4)
        pred = box_deltas.gather(2, target_cls.clamp(0, c - 1)[..., None, None].expand(b, rb, 1, 4))[:, :, 0]
        losses["loss_box_reg"] = ((pred - gt_deltas).abs().sum(-1) * sel_fg).sum() / n_fg

        if self.mask_on:
            if gt_masks is None:
                raise ValueError("GeneralizedRCNN with mask_on trains on gt_masks [B, K, H, W]")
            m = head_out["mask_logits"].shape[2]                                        # 2 x pooler_size
            with torch.no_grad():
                # each ROI samples its matched instance's bitmask alone (mask_rcnn_loss's crop)
                k = gt_masks.shape[1]
                items = (torch.arange(b, device=sel.device)[:, None] * k + sel_gt_idx).reshape(-1)
                bank = gt_masks.reshape(-1, *gt_masks.shape[2:])
                gt_crop = roi_align_per_item(bank, sel_rois.detach().reshape(-1, 4), items, (m, m), spatial_scale=1.0,
                                             sampling_ratio=2)
                gt_crop = (gt_crop.reshape(b, rb, m, m) > 0.5).float()
            cls_ch = gt_cls.clamp(0, c - 1)[:, :, None, None, None].expand(b, rb, m, m, 1)
            m_logits = head_out["mask_logits"].gather(-1, cls_ch)[..., 0]            # the ground truth's class
            per_roi = sigmoid_bce_with_logits(m_logits, gt_crop).mean((-2, -1))
            losses["loss_mask"] = (per_roi * sel_fg).sum() / n_fg

        if self.keypoint_on:
            if gt_keypoints is None:
                raise ValueError("GeneralizedRCNN with keypoint_on trains on gt_keypoints [B, K, num_keypoints, 3]")
            sel_kps = gt_keypoints.float().gather(1, sel_gt_idx[..., None, None].expand(
                -1, -1, *gt_keypoints.shape[2:]))                                     # [B, Rb, Kp, 3]
            kl = head_out["keypoint_logits"]
            losses["loss_keypoint"] = keypoint_rcnn_loss(kl.reshape(b * rb, *kl.shape[2:]),
                                                         sel_kps.reshape(b * rb, *sel_kps.shape[2:]),
                                                         sel_rois.reshape(b * rb, 4), sel_fg.reshape(b * rb))
        return losses

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

    def cascade_detections(self, boxes: torch.Tensor, scores: torch.Tensor):
        """The cascade's detections from its last stage's boxes [B, R, 4] and
        averaged scores [B, R, C]: per image the top 4D of the flattened
        scores, class-aware NMS, the top D. Returns boxes, scores, classes,
        valid, each [B, D(, 4)]."""
        outs = []
        for bx, sc in zip(boxes, scores):
            r, c = sc.shape
            top_sc, top_idx = _topk_stable(sc.reshape(-1), min(4 * self.max_detections, r * c))
            cand, cls = bx[top_idx // c], top_idx % c
            keep = batched_nms_mask(cand, top_sc, cls, self.test_nms_thresh, valid=top_sc > self.test_score_thresh)
            outv, outi = _topk_stable(torch.where(keep, top_sc, torch.full_like(top_sc, -1.0)), self.max_detections)
            outs.append((cand[outi], outv, cls[outi], outv > 0))
        return [torch.stack(t) for t in zip(*outs)]

    def inference_on_features(self, feats: Dict[str, torch.Tensor],
                              image_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        proposals = self.rpn([feats[f"p{i}"] for i in range(2, 7)], image_sizes, train=False)[0]
        if self.cascade_on:
            casc = self.roi_heads.inference(feats, proposals, image_sizes)
            boxes, scores, classes, valid = self.cascade_detections(casc["boxes"], casc["scores"])
            return {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid}
        head_out = self.roi_heads(feats, proposals)
        b, r = proposals.shape[:2]
        probs = torch.softmax(head_out["cls_logits"], -1)[..., :-1]
        box_deltas = head_out["box_deltas"].reshape(b, r, self.num_classes, 4)
        boxes, scores, classes, valid, det_idx = self.detections(proposals, probs, box_deltas, image_sizes)
        out = {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid}
        if self.mask_on:
            out["mask_probs"] = torch.sigmoid(self._class_masks(head_out["mask_logits"], det_idx, classes))
        if self.keypoint_on:
            out["keypoints"] = torch.stack([keypoint_rcnn_inference(kl[i], bx) for kl, i, bx in
                                            zip(head_out["keypoint_logits"], det_idx, boxes)])    # [B, D, K, 3]
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


class ProposalNetwork(nn.Module):
    """ResNet + FPN + RPN alone (reference meta_arch/rcnn.py:247): in eval mode
    ``inference`` returns proposal_boxes [B, R, 4] and objectness_logits
    [B, R]; in train mode ``forward`` returns the RPN's losses."""

    def __init__(self, backbone_depth: int = 50, fpn_channels: int = 256, proposals_per_image: int = 512,
                 dtype=torch.float32):
        super().__init__()
        self.backbone, self.fpn, self.rpn = _trunk(backbone_depth, fpn_channels, proposals_per_image, dtype)

    def _rpn(self, images: torch.Tensor, image_sizes: torch.Tensor, train: bool):
        feats = self.fpn(self.backbone(images))
        return self.rpn([feats[f"p{i}"] for i in range(2, 7)], image_sizes, train=train)

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor, targets: Optional[DetTargets] = None,
                generator: Optional[torch.Generator] = None):
        if not self.training:
            return self.inference(images, image_sizes)
        _, _, anchors, logits, deltas = self._rpn(images, image_sizes, train=True)
        return RPN.losses(logits, deltas, anchors, targets, generator)

    def inference(self, images: torch.Tensor, image_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        proposals, logits = self._rpn(images, image_sizes, train=False)[:2]
        return {"proposal_boxes": proposals, "objectness_logits": logits}
