"""Mask pasting (reference surface: detectron2/layers/mask_ops.py:275
paste_masks_in_image).

Counterpart of ``vnext_tpu.ops.mask_ops``: pasting an m x m mask into its box
is separable bilinear resampling, so each instance is two small products
against per-instance row and column weights: image pixel centre p maps to mask
coordinate (p + 0.5 - x0) / (x1 - x0) * m - 0.5, with zero outside the mask.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _paste_axis_weights(x0: torch.Tensor, x1: torch.Tensor, m: int, size: int) -> torch.Tensor:
    """[N, size, m] weights mapping mask coordinates to image pixels along one axis."""
    pix = torch.arange(size, dtype=torch.float32, device=x0.device)[None, :] + 0.5
    span = (x1 - x0).clamp_min(1e-6)[:, None]
    coord = (pix - x0[:, None]) / span * m - 0.5                    # [N, size]
    lo = torch.floor(coord)
    frac = coord - lo
    grid = torch.arange(m, dtype=torch.float32, device=x0.device)[None, None, :]
    zero = torch.zeros((), device=x0.device)
    return (torch.where(grid == lo[..., None], 1.0 - frac[..., None], zero)
            + torch.where(grid == lo[..., None] + 1.0, frac[..., None], zero))


def paste_masks_in_image(masks: torch.Tensor, boxes: torch.Tensor, image_shape: Tuple[int, int],
                         threshold: float = 0.5) -> torch.Tensor:
    """masks [N, m, m] probabilities, boxes [N, 4] xyxy in the image's
    coordinates -> [N, H, W] bool (>= threshold), or the f32 probabilities when
    ``threshold`` < 0."""
    h, w = image_shape
    m = masks.shape[-1]
    boxes = boxes.float()
    wy = _paste_axis_weights(boxes[:, 1], boxes[:, 3], m, h)       # [N, H, m]
    wx = _paste_axis_weights(boxes[:, 0], boxes[:, 2], m, w)       # [N, W, m]
    out = torch.bmm(torch.bmm(wy, masks.float()), wx.transpose(1, 2))
    return out >= threshold if threshold >= 0 else out
