"""RetinaNet: ResNet + FPN (p3-p7), the shared class and box towers, the
focal and smooth-L1 losses on IoU-matched anchors, and top-k + class-aware
NMS inference.

Counterpart of ``vnext_tpu.models.retinanet`` (reference surface:
detectron2/modeling/meta_arch/retinanet.py). Module and parameter names follow
the flax tree (``head.cls_conv{i}``, ``head.box_conv{i}``, ``head.cls_score``,
``head.bbox_pred``), so ``checkpoint/from_jax.py`` carries its parameters
across. Its fixed shapes and choices are kept: 3 anchors a location (one size
a level, three aspect ratios; the reference has 9), every anchor matched at
(0.4, 0.5) with low-quality matches and none sampled, the per-image top
``test_topk`` of each anchor's best class score before NMS, and every top-k a
stable descending sort, so ties go to the lower index as ``jax.lax.top_k``'s.
The model computes in f32 whatever ``TPU.COMPUTE_DTYPE`` says, as the JAX
package's ``build_model`` makes it, so the stem runs the f32 convolution and
no hand-written kernel.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.losses import sigmoid_focal_loss_elementwise
from ..ops.nms import batched_nms_mask
from ..parallel.mesh import global_count
from .backbones.fpn import FPN
from .backbones.resnet import ResNet
from .dense_heads import Box2BoxTransform, anchors_for_level, generate_cell_anchors, iou_matcher
from .layers import Conv
from .rcnn import DetTargets, _topk_stable


NUM_CONVS = 4          # each tower's 3x3 convolutions
PRIOR_PROB = 0.01


def prior_bias():
    """The class logits' bias init: sigmoid(bias) = ``PRIOR_PROB``."""
    value = -math.log((1 - PRIOR_PROB) / PRIOR_PROB)
    return lambda b: nn.init.constant_(b, value)


def _towers(module: nn.Module, in_channels: int) -> None:
    for tower in ("cls", "box"):
        for i in range(NUM_CONVS):
            module.add_module(f"{tower}_conv{i}", Conv(in_channels, in_channels, 3, 1, 1))


def _run_towers(module: nn.Module, f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    c = b = f
    for i in range(NUM_CONVS):
        c = torch.relu(getattr(module, f"cls_conv{i}")(c))
        b = torch.relu(getattr(module, f"box_conv{i}")(b))
    return c, b


def flatten_levels(maps: List[torch.Tensor], last: int) -> torch.Tensor:
    """NCHW maps of every level -> [B, sum H*W*A, last] in (level, y, x, anchor)
    order (the flax NHWC maps reshaped), f32."""
    return torch.cat([m.permute(0, 2, 3, 1).reshape(m.shape[0], -1, last) for m in maps], 1).float()


class RetinaNetHead(nn.Module):
    """The 4-conv class and box towers shared by every level, then ``cls_score``
    (A x C logits, bias at the prior probability) and ``bbox_pred`` (A x 4)."""

    def __init__(self, in_channels: int, num_classes: int, num_anchors: int):
        super().__init__()
        _towers(self, in_channels)
        self.cls_score = Conv(in_channels, num_anchors * num_classes, 3, 1, 1, bias_init=prior_bias())
        self.bbox_pred = Conv(in_channels, num_anchors * 4, 3, 1, 1)

    def forward(self, features: List[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        logits, deltas = [], []
        for f in features:
            c, b = _run_towers(self, f)
            logits.append(self.cls_score(c))
            deltas.append(self.bbox_pred(b))
        return logits, deltas


# the JAX modules' fixed fields (detectron2's RetinaNet / FCOS defaults; the configs set none of them)
STRIDES = (8, 16, 32, 64, 128)                    # p3-p7
ANCHOR_SIZES = ((32,), (64,), (128,), (256,), (512,))
ASPECT_RATIOS = (0.5, 1.0, 2.0)
IOU_THRESHOLDS = (0.4, 0.5)
FOCAL_ALPHA, FOCAL_GAMMA = 0.25, 2.0
SMOOTH_L1_BETA = 0.1
TEST_TOPK = 1000


class DenseDetector(nn.Module):
    """What RetinaNet and FCOS share: ResNet (res3-res5) + FPN (p3-p7, the
    P6P7 top block) in f32, and the selection of detections from dense
    scores."""

    dtype = torch.float32

    def __init__(self, num_classes: int, backbone_depth: int, fpn_channels: int, test_score_thresh: float,
                 test_nms_thresh: float, max_detections: int):
        super().__init__()
        self.num_classes = num_classes
        self.test_score_thresh, self.test_nms_thresh, self.max_detections = (test_score_thresh, test_nms_thresh,
                                                                              max_detections)
        features = ("res3", "res4", "res5")
        self.backbone = ResNet(backbone_depth, self.dtype, out_features=features)
        self.fpn = FPN([self.backbone.output_channels[f] for f in features], features, fpn_channels,
                       top_block="p6p7", dtype=self.dtype)

    def _features(self, images: torch.Tensor) -> List[torch.Tensor]:
        feats = self.fpn(self.backbone(images))
        return [feats[f"p{i}"] for i in range(3, 8)]

    def forward(self, images: torch.Tensor, targets: DetTargets = None, generator=None):
        """``inference`` in eval mode; in train mode the losses of ``targets``
        (``generator`` is taken for the train step's call and unused: nothing
        is sampled)."""
        if not self.training:
            return self.inference(images)
        return self.losses(*self._outputs(images), targets)

    def select(self, scores: torch.Tensor, boxes: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per image: each location's best class, the top ``TEST_TOPK`` of
        them, class-aware NMS, the top ``max_detections`` with the suppressed
        at -1. scores [B, N, C] probabilities, boxes [B, N, 4]."""
        k = min(TEST_TOPK, scores.shape[1])
        outs = []
        for sc, bx in zip(scores, boxes):
            best, cls = sc.max(1)                              # the first maximal class, as jnp.argmax
            topv, topi = _topk_stable(best, k)
            cand, ccls = bx[topi], cls[topi]
            keep = batched_nms_mask(cand, topv, ccls, self.test_nms_thresh, valid=topv > self.test_score_thresh)
            outv, outi = _topk_stable(torch.where(keep, topv, torch.full_like(topv, -1.0)), self.max_detections)
            outs.append((cand[outi], outv, ccls[outi], outv > 0))
        boxes, scores, classes, valid = (torch.stack(t) for t in zip(*outs))
        return {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid}


class RetinaNet(DenseDetector):
    """``forward(images, targets)`` in train mode returns loss_cls and
    loss_box_reg; ``inference(images)`` returns boxes [B, D, 4], scores,
    classes and valid [B, D] for D = ``max_detections``. Images are
    normalized NHWC [B, H, W, 3]; the boxes are not clipped, as in JAX."""

    def __init__(self, num_classes: int = 80, backbone_depth: int = 50, fpn_channels: int = 256,
                 test_score_thresh: float = 0.05, max_detections: int = 100):
        super().__init__(num_classes, backbone_depth, fpn_channels, test_score_thresh, 0.5, max_detections)
        self.cell_anchors = [generate_cell_anchors(s, ASPECT_RATIOS) for s in ANCHOR_SIZES]
        self.head = RetinaNetHead(fpn_channels, num_classes, len(ANCHOR_SIZES[0]) * len(ASPECT_RATIOS))
        self.box2box = Box2BoxTransform()
        self._anchors: Dict[tuple, torch.Tensor] = {}

    def anchors(self, features: List[torch.Tensor]) -> torch.Tensor:
        """[N, 4] anchors of every level, made once per level shapes and device."""
        shapes = tuple(tuple(f.shape[-2:]) for f in features)
        key = (shapes, str(features[0].device))
        if key not in self._anchors:
            self._anchors[key] = torch.cat([
                anchors_for_level(h, w, STRIDES[lvl], self.cell_anchors[lvl], features[0].device)
                for lvl, (h, w) in enumerate(shapes)])
        return self._anchors[key]

    def _outputs(self, images: torch.Tensor):
        """(logits [B, N, C], deltas [B, N, 4], anchors [N, 4]), f32."""
        features = self._features(images)
        logits_l, deltas_l = self.head(features)
        return flatten_levels(logits_l, self.num_classes), flatten_levels(deltas_l, 4), self.anchors(features)

    def match(self, anchors: torch.Tensor, targets: DetTargets):
        """Per image: (matched ground-truth slot [B, N], label [B, N])."""
        out = [iou_matcher(g, v, anchors, IOU_THRESHOLDS) for g, v in zip(targets.boxes, targets.valid)]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    def losses(self, logits: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
               targets: DetTargets) -> Dict[str, torch.Tensor]:
        """The focal loss over every anchor not ignored and smooth-L1 (beta
        ``SMOOTH_L1_BETA``) on the foreground's deltas, both divided by the
        batch's foreground count (at least 1)."""
        c = self.num_classes
        with torch.no_grad():
            matched_idx, labels = self.match(anchors, targets)
            fg = labels == 1
            valid_anchor = (labels >= 0).float()
            gt_cls = targets.labels.gather(1, matched_idx).long()
            onehot = F.one_hot(torch.where(fg, gt_cls, c), c + 1)[..., :-1].float()
            gt_boxes = targets.boxes.gather(1, matched_idx[..., None].expand(-1, -1, 4)).float()
            gt_deltas = self.box2box.get_deltas(anchors[None], gt_boxes)
            num_fg = global_count(fg.sum())
        cls_loss = sigmoid_focal_loss_elementwise(logits, onehot, FOCAL_ALPHA, FOCAL_GAMMA)
        loss_cls = (cls_loss * valid_anchor[..., None]).sum() / num_fg
        diff = (deltas - gt_deltas).abs()
        beta = SMOOTH_L1_BETA
        sl1 = torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)
        loss_box = (sl1.sum(-1) * fg).sum() / num_fg
        return {"loss_cls": loss_cls, "loss_box_reg": loss_box}

    def inference(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits, deltas, anchors = self._outputs(images)
        return self.select(torch.sigmoid(logits), self.box2box.apply_deltas(deltas, anchors[None]))
