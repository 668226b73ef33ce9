"""ROIAlignRotated: average-pooled bilinear samples over a rotated ROI grid.

Counterpart of ``vnext_tpu.ops.roi_align_rotated`` (reference surface:
detectron2/layers/roi_align_rotated.py). ROIs are (batch index, cx, cy, w, h,
angle in degrees), angles counter-clockwise; always aligned: the centre moves
by -0.5 pixel. A sample with x or y at <= -1 or at >= the map's side weighs
0; any other is clamped into [0, side - 1] before its four corners are read
(so one in (-1, 0) reads the first row or column at full weight), as the JAX
package's ``_bilinear_gather``. Each sample gathers its four corners from
the map viewed channels-last, as ``ops/roi_align.py`` does. Plain torch: this
was no Pallas kernel in the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def roi_align_rotated(features: torch.Tensor, rois: torch.Tensor, output_size: Tuple[int, int] = (7, 7),
                      spatial_scale: float = 1.0, sampling_ratio: int = 2) -> torch.Tensor:
    """features [B, C, H, W] (the port's layout; the JAX package's is NHWC);
    rois [N, 6]. Returns [N, out_h, out_w, C] in f32 (in the features' dtype
    promoted with f32), the JAX package's layout."""
    fm = features.permute(0, 2, 3, 1)
    b, h, w, c = fm.shape
    out_h, out_w = output_size
    s = max(sampling_ratio, 1)
    rois = rois.float()
    n = rois.shape[0]
    cx = rois[:, 1] * spatial_scale - 0.5
    cy = rois[:, 2] * spatial_scale - 0.5
    rw = rois[:, 3] * spatial_scale
    rh = rois[:, 4] * spatial_scale
    theta = rois[:, 5] * math.pi / 180.0
    bin_w, bin_h = rw / out_w, rh / out_h
    dev = rois.device
    py = (torch.arange(out_h * s, dtype=torch.float32, device=dev) + 0.5) / s
    px = (torch.arange(out_w * s, dtype=torch.float32, device=dev) + 0.5) / s
    yy = py[None] * bin_h[:, None] - (bin_h * out_h / 2.0)[:, None]       # [N, out_h * s]
    xx = px[None] * bin_w[:, None] - (bin_w * out_w / 2.0)[:, None]       # [N, out_w * s]
    gy, gx = yy[:, :, None], xx[:, None, :]
    cos_t, sin_t = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    sx = gx * cos_t - gy * sin_t + cx[:, None, None]                      # [N, out_h * s, out_w * s]
    sy = gx * sin_t + gy * cos_t + cy[:, None, None]
    inside = (sx > -1.0) & (sx < w) & (sy > -1.0) & (sy < h)
    sx = sx.clamp(0.0, w - 1)
    sy = sy.clamp(0.0, h - 1)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    tx, ty = sx - x0, sy - y0
    flat = fm.reshape(b * h * w, c)
    base = (rois[:, 0].long() * (h * w))[:, None, None]
    out = 0.0
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xi = torch.clamp_max(x0 + dx, w - 1).long()
        yi = torch.clamp_max(y0 + dy, h - 1).long()
        wgt = (tx if dx else 1 - tx) * (ty if dy else 1 - ty)
        g = flat[(base + yi * w + xi).reshape(-1)].reshape(*sx.shape, c)
        out = out + g * wgt[..., None]
    out = out * inside[..., None]
    return out.reshape(n, out_h, s, out_w, s, c).mean(dim=(2, 4))
