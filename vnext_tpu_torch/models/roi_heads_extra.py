"""The keypoint head of keypoint R-CNN, its loss and its decoding.

Counterpart of part of ``vnext_tpu.models.roi_heads_extra`` (reference
surface: detectron2/modeling/roi_heads/keypoint_head.py
KRCNNConvDeconvUpsampleHead, keypoint_rcnn_loss, keypoint_rcnn_inference).
``Res5ROIHeads``, ``Box2BoxTransformRotated`` and ``RROIHeads`` need the
rotated ops and wait for them (ROADMAP Queue 1, item 11e).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.interpolate import resize_bilinear
from ..structures.keypoints import Keypoints
from .layers import Conv, ConvTranspose


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
    return (ce * w).sum() / w.sum().clamp_min(1.0)


def keypoint_rcnn_inference(heatmap_logits: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """[N, K, 3] (x, y, score) decoded from per-ROI heatmaps."""
    return Keypoints.from_heatmap(heatmap_logits, rois)
