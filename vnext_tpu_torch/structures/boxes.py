"""Box operations: the matcher's, the criterion's and the R-CNN's.

Counterpart of ``vnext_tpu.structures.boxes`` but for ``RotatedBoxes`` (ROADMAP
Queue 1, item 11e). Boxes are [..., 4]; the pairwise functions take sets
[..., N, 4] and [..., M, 4] with any leading batch dimensions and return
[..., N, M]. ``BoxMode`` converts the host's numpy annotation boxes (the
visualizer draws them); ``Boxes`` wraps an [N, 4] xyxy tensor.
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

_TINY = torch.finfo(torch.float32).tiny


class BoxMode(enum.IntEnum):
    """Coordinate interpretation of a (..., 4) or (..., 5) box array (reference:
    structures/boxes.py:13), on numpy in f32 as ``vnext_tpu``'s on jnp."""

    XYXY_ABS = 0
    XYWH_ABS = 1
    XYXY_REL = 2
    XYWH_REL = 3
    XYWHA_ABS = 4

    @staticmethod
    def convert(box, from_mode: "BoxMode", to_mode: "BoxMode"):
        if from_mode == to_mode:
            return box
        original_type = type(box)
        arr = np.asarray(box, dtype=np.float32)
        if from_mode == BoxMode.XYWHA_ABS and to_mode == BoxMode.XYXY_ABS:
            if arr.shape[-1] != 5:
                raise ValueError("XYWHA_ABS boxes must have shape (..., 5)")
            xc, yc, w, h, a = np.split(arr, 5, axis=-1)
            theta = a * np.float32(math.pi / 180.0)
            c, s = np.abs(np.cos(theta)), np.abs(np.sin(theta))
            new_w, new_h = c * w + s * h, c * h + s * w
            out = np.concatenate([xc - new_w / 2, yc - new_h / 2, xc + new_w / 2, yc + new_h / 2], axis=-1)
        elif from_mode == BoxMode.XYWH_ABS and to_mode == BoxMode.XYWHA_ABS:
            x, y, w, h = np.split(arr, 4, axis=-1)
            out = np.concatenate([x + w / 2, y + h / 2, w, h, np.zeros_like(w)], axis=-1)
        elif to_mode == BoxMode.XYXY_ABS and from_mode == BoxMode.XYWH_ABS:
            x, y, w, h = np.split(arr, 4, axis=-1)
            out = np.concatenate([x, y, x + w, y + h], axis=-1)
        elif from_mode == BoxMode.XYXY_ABS and to_mode == BoxMode.XYWH_ABS:
            x1, y1, x2, y2 = np.split(arr, 4, axis=-1)
            out = np.concatenate([x1, y1, x2 - x1, y2 - y1], axis=-1)
        else:
            raise NotImplementedError(f"Conversion {from_mode} -> {to_mode} not supported")
        if original_type in (list, tuple):
            return original_type(out.tolist())
        return out


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    xc, yc, w, h = x.unbind(-1)
    return torch.stack([xc - 0.5 * w, yc - 0.5 * h, xc + 0.5 * w, yc + 0.5 * h], -1)


def box_xyxy_to_cxcywh(x: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


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


def clip_boxes(boxes: torch.Tensor, image_size) -> torch.Tensor:
    """Clip xyxy boxes to [0, W] x [0, H]; ``image_size`` is (H, W), numbers or
    tensors broadcasting against ``boxes[..., 0]``."""
    h, w = image_size
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    h = torch.as_tensor(h, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(w, dtype=boxes.dtype, device=boxes.device)
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([torch.clamp(x1, zero, w), torch.clamp(y1, zero, h),
                        torch.clamp(x2, zero, w), torch.clamp(y2, zero, h)], -1)


def nonempty_boxes(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Bool mask of boxes with both sides > threshold."""
    return ((boxes[..., 2] - boxes[..., 0]) > threshold) & ((boxes[..., 3] - boxes[..., 1]) > threshold)


class Boxes:
    """Thin wrapper over an (N, 4) xyxy f32 tensor (reference: structures/boxes.py Boxes)."""

    def __init__(self, tensor):
        tensor = torch.as_tensor(tensor, dtype=torch.float32)
        if tensor.ndim != 2 or tensor.shape[-1] != 4:
            raise ValueError(f"Boxes tensor must be (N, 4), got {tuple(tensor.shape)}")
        self.tensor = tensor

    def area(self) -> torch.Tensor:
        return box_area(self.tensor)

    def clip(self, image_size) -> "Boxes":
        return Boxes(clip_boxes(self.tensor, image_size))

    def nonempty(self, threshold: float = 0.0) -> torch.Tensor:
        return nonempty_boxes(self.tensor, threshold)

    def get_centers(self) -> torch.Tensor:
        return (self.tensor[:, :2] + self.tensor[:, 2:]) / 2

    def scale(self, scale_x: float, scale_y: float) -> "Boxes":
        s = torch.tensor([scale_x, scale_y, scale_x, scale_y], dtype=torch.float32, device=self.tensor.device)
        return Boxes(self.tensor * s)

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __getitem__(self, item) -> "Boxes":
        t = self.tensor[item]
        return Boxes(t[None] if t.ndim == 1 else t)

    def __repr__(self) -> str:
        return f"Boxes({self.tensor})"

    @classmethod
    def cat(cls, boxes_list) -> "Boxes":
        return cls(torch.cat([b.tensor for b in boxes_list], 0))
