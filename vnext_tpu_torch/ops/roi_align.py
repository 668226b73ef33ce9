"""ROIAlign by gathering each sample's four bilinear corners.

Counterpart of ``vnext_tpu.ops.roi_align`` (reference surface:
detectron2/layers/roi_align.py, torchvision's ``roi_align``). Each output bin
averages ``sampling_ratio`` x ``sampling_ratio`` bilinear samples at
``start + (bin + (j + 0.5) / s) * bin_size``; ``aligned=True`` moves the ROI by
-0.5 pixel. A sample at <= -1 or >= the map's side weighs 0; any other is
clamped into [0, side - 1] before its corners are taken, as the JAX package's
``_axis_weights``.

The JAX package contracts dense one-hot weight matrices with the feature map,
64 ROIs at a time, which suits the TPU's matrix unit. Here each sample reads
its four corners from the map, viewed channels-last (on the card the maps are
``channels_last`` in memory, so the view is free), with one gather each: the samples
are 4 * N * (7 * 2)^2 rows of C channels, and nothing [N, H, W] is ever made.
``roi_align_levels`` pools every ROI from its own FPN level in one pass by
gathering from the levels laid end to end. ``roi_align_per_item`` (Mask
R-CNN's mask targets) samples each ROI from its own item of a single-channel
bank [M, H, W] of any dtype (the ground-truth bitmasks stay bool: only the
sampled corners are read and made f32). Plain torch: none of these was a
Pallas kernel in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _axis_samples(start: torch.Tensor, bin_size: torch.Tensor, n_bins: int, s: int, size: torch.Tensor):
    """One axis's sample corners: (lo, hi, w_lo, w_hi), each [N, n_bins * s];
    ``size`` [N] (or a scalar) is the map's side along the axis."""
    offs = ((torch.arange(n_bins, dtype=torch.float32, device=start.device)[:, None]
             + (torch.arange(s, dtype=torch.float32, device=start.device)[None, :] + 0.5) / s)).reshape(-1)
    pos = start[:, None] + offs[None, :] * bin_size[:, None]
    size = torch.as_tensor(size, dtype=torch.float32, device=start.device).reshape(-1, 1)
    valid = (pos > -1.0) & (pos < size)
    pc = torch.minimum(pos.clamp_min(0.0), size - 1.0)
    lo = torch.floor(pc)
    frac = pc - lo
    hi = torch.minimum(lo + 1, size - 1.0)
    w_hi = torch.where(valid, frac, torch.zeros_like(frac))
    w_lo = torch.where(valid, 1.0 - frac, torch.zeros_like(frac))
    return lo.long(), hi.long(), w_lo, w_hi


def _roi_box(rois4: torch.Tensor, spatial_scale, aligned: bool):
    """(x1, y1, roi_w, roi_h) in map coordinates; ``spatial_scale`` a number or [N]."""
    offset = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (rois4.float() * torch.as_tensor(spatial_scale, dtype=torch.float32,
                                                      device=rois4.device).reshape(-1, 1) - offset).unbind(-1)
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w, roi_h = roi_w.clamp_min(1.0), roi_h.clamp_min(1.0)
    return x1, y1, roi_w, roi_h


def _pool(flat: torch.Tensor, base: torch.Tensor, width: torch.Tensor, ys, xs, out_h: int, out_w: int,
          s: int) -> torch.Tensor:
    """Bilinear samples from ``flat`` [M, C] (row ``base + y * width + x``), each
    bin the mean of its s x s samples: [N, out_h, out_w, C] in f32."""
    y_lo, y_hi, wy_lo, wy_hi = ys
    x_lo, x_hi, wx_lo, wx_hi = xs
    n, c = base.shape[0], flat.shape[1]
    rows_lo = base[:, None] + y_lo * width[:, None]                   # [N, qh]
    rows_hi = base[:, None] + y_hi * width[:, None]

    def corner(rows, cols):
        idx = (rows[:, :, None] + cols[:, None, :]).reshape(-1)       # [N * qh * qw]
        return flat.index_select(0, idx).reshape(n, rows.shape[1], cols.shape[1], c).float()

    top = wx_lo[:, None, :, None] * corner(rows_lo, x_lo) + wx_hi[:, None, :, None] * corner(rows_lo, x_hi)
    bottom = wx_lo[:, None, :, None] * corner(rows_hi, x_lo) + wx_hi[:, None, :, None] * corner(rows_hi, x_hi)
    out = wy_lo[:, :, None, None] * top + wy_hi[:, :, None, None] * bottom     # [N, qh, qw, C]
    return out.reshape(n, out_h, s, out_w, s, c).mean(dim=(2, 4))


def roi_align(features: torch.Tensor, rois: torch.Tensor, output_size: Tuple[int, int] = (7, 7),
              spatial_scale: float = 1.0, sampling_ratio: int = 2, aligned: bool = True) -> torch.Tensor:
    """features [B, C, H, W]; rois [N, 5] (batch index, x1, y1, x2, y2) in image
    coordinates. Returns [N, out_h, out_w, C] in f32, the JAX package's layout."""
    fm = features.permute(0, 2, 3, 1)
    b, h, w, c = fm.shape
    out_h, out_w = output_size
    s = max(sampling_ratio, 1)
    x1, y1, roi_w, roi_h = _roi_box(rois[:, 1:5], spatial_scale, aligned)
    size_h = torch.full_like(y1, h)
    size_w = torch.full_like(x1, w)
    ys = _axis_samples(y1, roi_h / out_h, out_h, s, size_h)
    xs = _axis_samples(x1, roi_w / out_w, out_w, s, size_w)
    base = rois[:, 0].long() * (h * w)
    return _pool(fm.reshape(b * h * w, c), base, torch.full_like(base, w), ys, xs, out_h, out_w, s)


def roi_align_per_item(bank: torch.Tensor, rois4: torch.Tensor, item_idx: torch.Tensor,
                       output_size: Tuple[int, int] = (28, 28), spatial_scale: float = 1.0, sampling_ratio: int = 2,
                       aligned: bool = True) -> torch.Tensor:
    """ROI i pooled from ``bank[item_idx[i]]`` alone: bank [M, H, W], rois4 [N, 4]
    xyxy in bank coordinates, item_idx [N]. Returns [N, out_h, out_w] in f32."""
    m, h, w = bank.shape
    out_h, out_w = output_size
    s = max(sampling_ratio, 1)
    x1, y1, roi_w, roi_h = _roi_box(rois4, spatial_scale, aligned)
    ys = _axis_samples(y1, roi_h / out_h, out_h, s, torch.full_like(y1, h))
    xs = _axis_samples(x1, roi_w / out_w, out_w, s, torch.full_like(x1, w))
    base = item_idx.long() * (h * w)
    return _pool(bank.reshape(m * h * w, 1), base, torch.full_like(base, w), ys, xs, out_h, out_w, s)[..., 0]


def roi_align_levels(features: Sequence[torch.Tensor], rois: torch.Tensor, levels: torch.Tensor,
                     strides: Sequence[int], output_size: Tuple[int, int] = (7, 7), sampling_ratio: int = 2,
                     aligned: bool = True) -> torch.Tensor:
    """Each ROI pooled from ``features[levels[i]]`` only (NCHW maps of one batch,
    ``strides[l]`` their strides): equal to pooling every level and keeping each
    ROI's own, which is the JAX package's one-hot-weighted sum over levels.
    rois [N, 5] as ``roi_align``'s, levels [N] int indices into ``features``."""
    maps = [f.permute(0, 2, 3, 1) for f in features]
    b, c = maps[0].shape[0], maps[0].shape[-1]
    dev = rois.device
    hs = torch.tensor([m.shape[1] for m in maps], device=dev)
    ws = torch.tensor([m.shape[2] for m in maps], device=dev)
    starts = torch.tensor([0] + [b * m.shape[1] * m.shape[2] for m in maps[:-1]], device=dev).cumsum(0)
    scales = torch.tensor([1.0 / st for st in strides], dtype=torch.float32, device=dev)
    flat = torch.cat([m.reshape(-1, c) for m in maps], 0)
    out_h, out_w = output_size
    s = max(sampling_ratio, 1)
    lv = levels.long()
    h, w = hs[lv], ws[lv]
    x1, y1, roi_w, roi_h = _roi_box(rois[:, 1:5], scales[lv], aligned)
    ys = _axis_samples(y1, roi_h / out_h, out_h, s, h)
    xs = _axis_samples(x1, roi_w / out_w, out_w, s, w)
    base = starts[lv] + rois[:, 0].long() * h * w
    return _pool(flat, base, w, ys, xs, out_h, out_w, s)
