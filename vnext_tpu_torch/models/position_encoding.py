"""Sine position embedding over the valid (unpadded) image region.

Counterpart of ``vnext_tpu.models.position_encoding``: padding is always a
bottom/right rectangle, so the reference's cumulative sum over the not-padded
mask at valid pixel (y, x) is (y+1, x+1) and the embedding has a closed form in
the per-image valid (h, w). Channel order is (y-part, x-part).
"""

from __future__ import annotations

import math

import torch


def sine_position_embedding(
    valid_hw: torch.Tensor,   # [B, 2] valid rows/cols at this level
    feat_h: int,
    feat_w: int,
    num_pos_feats: int = 128,
    offset: float = 0.5,
) -> torch.Tensor:
    """[B, H, W, 2*num_pos_feats] f32 embedding (temperature 1e4). ``offset``
    0.5 is the Deformable-DETR / IDOL convention (cumsum - 0.5), 1.0 the
    Mask2Former one (the plain cumsum)."""
    temperature = 10000.0
    scale = 2 * math.pi
    eps = 1e-6
    dev = valid_hw.device
    b = valid_hw.shape[0]
    ys = torch.arange(feat_h, dtype=torch.float32, device=dev) + offset
    xs = torch.arange(feat_w, dtype=torch.float32, device=dev) + offset
    vh = valid_hw[:, 0].float()[:, None]
    vw = valid_hw[:, 1].float()[:, None]
    y_embed = ys[None, :] / (vh + eps) * scale                      # [B, H]
    x_embed = xs[None, :] / (vw + eps) * scale                      # [B, W]

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=dev)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    def interleave(p):  # stack(sin(p[0::2]), cos(p[1::2])) flattened
        return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], dim=-1).flatten(-2)

    pos_y = interleave(y_embed[:, :, None] / dim_t)                 # [B, H, F]
    pos_x = interleave(x_embed[:, :, None] / dim_t)                 # [B, W, F]
    pos_y = pos_y[:, :, None, :].expand(b, feat_h, feat_w, num_pos_feats)
    pos_x = pos_x[:, None, :, :].expand(b, feat_h, feat_w, num_pos_feats)
    return torch.cat([pos_y, pos_x], dim=-1)
