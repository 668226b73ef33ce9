"""Keypoints container with the heatmap conversions of keypoint R-CNN.

Counterpart of ``vnext_tpu.structures.keypoints`` (reference surface:
detectron2/structures/keypoints.py): [N, K, 3] (x, y, visibility) keypoints,
``to_heatmap`` for the head's targets and ``from_heatmap`` for its decoding.
The floor, the clip and the argmax (the first maximal index) are the JAX
package's, so the targets and the decoded positions are equal to its own.
"""

from __future__ import annotations

from typing import Tuple

import torch


class Keypoints:
    def __init__(self, tensor):
        tensor = torch.as_tensor(tensor, dtype=torch.float32)
        if tensor.dim() != 3 or tensor.shape[-1] != 3:
            raise ValueError(f"Keypoints tensor must be (N, K, 3), got {tuple(tensor.shape)}")
        self.tensor = tensor

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __getitem__(self, item) -> "Keypoints":
        t = self.tensor[item]
        return Keypoints(t[None] if t.dim() == 2 else t)

    def to_heatmap(self, boxes: torch.Tensor, heatmap_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each keypoint's cell of its ROI's ``heatmap_size``² grid (reference
        keypoints.py _keypoints_to_heatmap). boxes [N, 4] xyxy. Returns the
        flat cell index [N, K] (int64) and valid [N, K]: inside the box and
        visible."""
        x1, y1, x2, y2 = (boxes[:, i:i + 1] for i in range(4))
        sx = heatmap_size / (x2 - x1).clamp_min(1e-6)
        sy = heatmap_size / (y2 - y1).clamp_min(1e-6)
        kx, ky, vis = self.tensor[..., 0], self.tensor[..., 1], self.tensor[..., 2]
        xi = torch.floor((kx - x1) * sx).clamp(0, heatmap_size - 1).long()
        yi = torch.floor((ky - y1) * sy).clamp(0, heatmap_size - 1).long()
        inside = (kx >= x1) & (kx < x2) & (ky >= y1) & (ky < y2)
        return yi * heatmap_size + xi, inside & (vis > 0)

    @staticmethod
    def from_heatmap(heatmaps: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Heatmap logits [N, S, S, K] -> image-space keypoints [N, K, 3]: each
        keypoint at its cell's centre (the first maximal cell), scored by its
        softmax over the grid."""
        n, hs, _, k = heatmaps.shape
        flat = heatmaps.permute(0, 3, 1, 2).reshape(n, k, hs * hs)
        idx = flat.argmax(-1)
        score = torch.softmax(flat, -1).amax(-1)
        yi = torch.div(idx, hs, rounding_mode="floor").float() + 0.5
        xi = (idx % hs).float() + 0.5
        x1, y1, x2, y2 = (boxes[:, i:i + 1] for i in range(4))
        return torch.stack([x1 + xi / hs * (x2 - x1), y1 + yi / hs * (y2 - y1), score], -1)
