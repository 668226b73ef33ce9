"""Semantic segmentation: the FPN head, SemanticSegmentor, and the panoptic fusion.

Counterpart of ``vnext_tpu.models.semantic_seg`` (reference surface:
detectron2/modeling/meta_arch/semantic_seg.py SemanticSegmentor and
SemSegFPNHead, panoptic_fpn.py combine_semantic_and_instance_outputs).
Module and parameter names follow the flax tree (``sem_seg_head``,
``head_p{2..5}_conv``, ``head_p{2..5}_norm``, ``predictor``), so
``checkpoint/from_jax.py`` carries the JAX package's parameters across.

The JAX package's head is kept: one 3x3 convolution, GroupNorm(32) (flax's,
eps 1e-6) and ReLU a level, each level resized bilinearly to p2's size, the
sum through a 1x1 predictor, f32 logits at H/4 (detectron2 stacks
convolutions with x2 upsamplings). The loss is the per-pixel cross-entropy at
H/4 against labels taken to H/4 by the mapper, ``ignore_value`` left out
(detectron2 upsamples the logits to the image first); ``inference`` is the
argmax at H/4. The fusion keeps semantic class 0 as a stuff segment and puts
the contiguous thing ids and the raw stuff ids in one space (detectron2 skips
class 0 and maps the stuff ids): ROADMAP Queue 3, item 5.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.interpolate import resize_bilinear
from ..parallel.mesh import global_count
from .backbones.fpn import FPN
from .backbones.resnet import ResNet
from .layers import Conv, GroupNorm


class SemSegFPNHead(nn.Module):
    """Per-pixel class logits from the FPN levels ``in_features`` (NCHW, finest
    first): [B, num_classes, H/4, W/4] f32 at the finest level's size."""

    def __init__(self, num_classes: int, in_channels: int = 256,
                 in_features: Sequence[str] = ("p2", "p3", "p4", "p5"), conv_dim: int = 128, dtype=torch.float32):
        super().__init__()
        self.in_features = tuple(in_features)
        for name in self.in_features:
            self.add_module(f"head_{name}_conv", Conv(in_channels, conv_dim, 3, 1, 1, dtype=dtype))
            self.add_module(f"head_{name}_norm", GroupNorm(32, conv_dim, dtype))
        self.predictor = Conv(conv_dim, num_classes, 1, dtype=dtype)

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        target = tuple(features[self.in_features[0]].shape[-2:])
        summed = 0.0
        for name in self.in_features:
            x = getattr(self, f"head_{name}_conv")(features[name])
            x = torch.relu(getattr(self, f"head_{name}_norm")(x))
            if tuple(x.shape[-2:]) != target:
                x = resize_bilinear(x, *target)
            summed = summed + x
        return self.predictor(summed).float()


def sem_seg_loss(logits: torch.Tensor, sem_seg_gt: torch.Tensor, ignore_value: int) -> torch.Tensor:
    """Mean cross-entropy of logits [B, C, h, w] against labels [B, h, w] over
    the pixels not labelled ``ignore_value`` (0 where there are none)."""
    valid = sem_seg_gt != ignore_value
    gt = torch.where(valid, sem_seg_gt, torch.zeros_like(sem_seg_gt)).long()
    ce = -torch.log_softmax(logits, 1).gather(1, gt[:, None])[:, 0]
    return (ce * valid).sum() / global_count(valid.sum())


class SemanticSegmentor(nn.Module):
    """ResNet + FPN (p2-p5, no top block) + ``SemSegFPNHead``. ``inference``
    takes normalized NHWC images [B, H, W, 3] and returns the argmax [B, H/4,
    W/4]; in train mode ``forward`` returns {"loss_sem_seg"} of labels [B,
    H/4, W/4]."""

    def __init__(self, num_classes: int = 54, backbone_depth: int = 50, fpn_channels: int = 256,
                 ignore_value: int = 255, dtype=torch.float32):
        super().__init__()
        self.num_classes, self.ignore_value, self.dtype = num_classes, ignore_value, dtype
        features = ("res2", "res3", "res4", "res5")
        self.backbone = ResNet(backbone_depth, dtype, out_features=features)
        self.fpn = FPN([self.backbone.output_channels[f] for f in features], features, fpn_channels,
                       top_block="none", dtype=dtype)
        self.sem_seg_head = SemSegFPNHead(num_classes, fpn_channels, dtype=dtype)

    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """[B, num_classes, H/4, W/4] f32."""
        return self.sem_seg_head(self.fpn(self.backbone(images)))

    def forward(self, images: torch.Tensor, sem_seg_gt: torch.Tensor = None, generator=None):
        """``inference`` in eval mode; in train mode the loss of ``sem_seg_gt``
        (the step's generator is not drawn from)."""
        if not self.training:
            return self.inference(images)
        return {"loss_sem_seg": sem_seg_loss(self.logits(images), sem_seg_gt, self.ignore_value)}

    def inference(self, images: torch.Tensor) -> torch.Tensor:
        return self.logits(images).argmax(1)


def combine_semantic_and_instance_outputs(
    sem_seg: np.ndarray,
    instance_masks: np.ndarray,
    instance_scores: np.ndarray,
    instance_classes: np.ndarray,
    overlap_threshold: float = 0.5,
    stuff_area_limit: int = 4096,
    instances_score_thresh: float = 0.5,
) -> Tuple[np.ndarray, list]:
    """Greedy panoptic fusion of a class map [H, W], instance masks [N, H, W]
    bool, their scores [N] and classes [N]: the instances by score while it
    is at least ``instances_score_thresh``, each kept where at least
    ``overlap_threshold`` of it is still free; then each semantic class's free
    pixels, where there are ``stuff_area_limit`` of them or more. Returns the
    id map [H, W] int32 (0: no segment) and the segments' info."""
    h, w = sem_seg.shape
    panoptic = np.zeros((h, w), np.int32)
    segments = []
    current_id = 0
    order = np.argsort(-instance_scores)
    for i in order:
        if instance_scores[i] < instances_score_thresh:
            break
        mask = instance_masks[i] & (panoptic == 0)
        orig_area = instance_masks[i].sum()
        if orig_area == 0:
            continue
        if mask.sum() / orig_area < overlap_threshold:
            continue
        current_id += 1
        panoptic[mask] = current_id
        segments.append({"id": current_id, "isthing": True, "score": float(instance_scores[i]),
                         "category_id": int(instance_classes[i])})
    for cls in np.unique(sem_seg):
        mask = (sem_seg == cls) & (panoptic == 0)
        if mask.sum() < stuff_area_limit:
            continue
        current_id += 1
        panoptic[mask] = current_id
        segments.append({"id": current_id, "isthing": False, "category_id": int(cls)})
    return panoptic, segments
