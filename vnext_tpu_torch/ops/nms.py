"""Fixed-shape greedy NMS over box sets, in plain torch.

Counterpart of ``vnext_tpu.ops.nms``'s ``nms_mask`` and ``batched_nms_mask``:
instead of a list of kept indices they return a bool keep mask over a padded
set, so that they run on the device with no copy to the host. Suppression is
torchvision's sequential greedy rule over the score-sorted IoU matrix, a loop
of one small device operation per box (the JAX package's ``fori_loop``).
torchvision is not a dependency of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..structures.boxes import pairwise_iou


def greedy_keep(suppresses: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Sequential greedy suppression: ``suppresses`` [N, N] bool, row i the
    boxes that box i suppresses if it is kept (only those after i count);
    ``keep`` [N] the boxes that start kept. Returns the keep mask after
    walking i = 0 .. N - 2 in order, on ``keep``'s device."""
    n = keep.shape[0]
    later = torch.ones(n, n, dtype=torch.bool, device=keep.device).triu(1)
    drop = (suppresses & later).float()
    kept = keep.float()
    for i in range(n - 1):
        kept = kept * (1.0 - drop[i] * kept[i])
    return kept > 0


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy NMS over [N, 4] xyxy boxes; the keep mask [N] in the input
    order. Scores tie toward the lower index (a stable sort, as
    ``jnp.argsort``); boxes outside ``valid`` are never kept and suppress
    nothing."""
    n = boxes.shape[0]
    s = scores if valid is None else torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(s, descending=True, stable=True).indices
    sorted_boxes = boxes[order]
    keep_sorted = greedy_keep(pairwise_iou(sorted_boxes, sorted_boxes) > iou_threshold,
                              torch.ones(n, dtype=torch.bool, device=boxes.device))
    if valid is not None:
        keep_sorted = keep_sorted & valid[order]
    return torch.zeros_like(keep_sorted).index_put((order,), keep_sorted)


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor, iou_threshold: float,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Class-aware NMS by the coordinate-offset trick (torchvision's
    ``batched_nms``): each class's boxes are moved past every other's by
    ``idx * 2 * (max |coordinate| + 1)``."""
    if boxes.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=boxes.device)
    max_coord = boxes.abs().max() + 1
    shifted = boxes + (idxs.to(boxes.dtype) * (2 * max_coord))[:, None]
    return nms_mask(shifted, scores, iou_threshold, valid=valid)
