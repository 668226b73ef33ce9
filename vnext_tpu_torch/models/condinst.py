"""CondInst dynamic mask head.

Counterpart of ``vnext_tpu.models.condinst``: a small conv tower fuses the three
finest encoder memory levels into stride-8 mask features, a controller MLP emits
169 dynamic parameters per query (three 1x1 conv layers of 8 channels, with
relative coordinates), and the dynamic convs run as batched products over the
flattened grid, followed by ``aligned_bilinear`` to the mask stride.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..ops.interpolate import aligned_bilinear, compute_locations, resize_nearest
from .layers import Conv

DYNAMIC_CHANNELS = 8
CONTROLLER_LAYERS = 3


def dynamic_params_layout(in_channels: int) -> Tuple[List[int], List[int]]:
    """(weight_nums, bias_nums) per dynamic layer; the first layer also sees the
    two relative coordinates."""
    c0 = in_channels + 2
    ch = DYNAMIC_CHANNELS
    return [c0 * ch, ch * ch, ch], [ch, ch, 1]


def num_dynamic_params(in_channels: int) -> int:
    w, b = dynamic_params_layout(in_channels)
    return sum(w) + sum(b)


class MaskHeadSmallConv(nn.Module):
    """Fuse [stride8, stride16, stride32] NCHW features into [B, dim//32, H8, W8]."""

    def __init__(self, dim: int = 256, dtype=torch.float32):
        super().__init__()

        def conv(cin, cout):
            return Conv(cin, cout, 3, 1, 1, dtype=dtype, kernel_init="kaiming")

        self.lay3 = conv(dim, dim)
        self.lay4 = conv(dim, dim)
        self.dcn = conv(dim, dim)
        self.lay1 = conv(dim, dim // 4)
        self.lay2 = conv(dim // 4, dim // 32)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        x = torch.relu(self.lay3(feats[2]))
        x = feats[1] + resize_nearest(x, feats[1].shape[2], feats[1].shape[3])
        x = torch.relu(self.lay4(x))
        x = feats[0] + resize_nearest(x, feats[0].shape[2], feats[0].shape[3])
        x = torch.relu(self.dcn(x))
        x = torch.relu(self.lay1(x))
        return torch.relu(self.lay2(x))


def run_dynamic_mask_head(
    mask_feats: torch.Tensor,        # [B, C_m, H, W] stride-8 mask features
    reference_points: torch.Tensor,  # [B, N, 2] absolute (x, y) in input pixels
    params: torch.Tensor,            # [B, N, num_params] controller outputs
    mask_feat_stride: int = 8,
    mask_out_stride: int = 4,
) -> torch.Tensor:
    """Mask logits [B, N, H*up, W*up] at the mask output stride."""
    b, c_m, h, w = mask_feats.shape
    n = reference_points.shape[1]
    weight_nums, bias_nums = dynamic_params_layout(c_m)
    ch = DYNAMIC_CHANNELS

    x = mask_feats.flatten(2).transpose(1, 2)[:, None].expand(b, n, h * w, c_m)
    locations = compute_locations(h, w, mask_feat_stride, device=mask_feats.device)
    rel = reference_points[:, :, None, :] - locations[None, None]              # [B, N, HW, 2]
    x = torch.cat([rel.to(x.dtype), x], dim=-1)                                 # coords first

    splits = torch.split(params, weight_nums + bias_nums, dim=-1)
    w_splits, b_splits = splits[:CONTROLLER_LAYERS], splits[CONTROLLER_LAYERS:]
    dims = [c_m + 2, ch, ch, 1]
    out = x
    for layer in range(CONTROLLER_LAYERS):
        wt = w_splits[layer].reshape(b, n, dims[layer + 1], dims[layer])         # [B, N, out, in]
        bs = b_splits[layer].reshape(b, n, 1, dims[layer + 1])
        out = torch.matmul(out, wt.transpose(-1, -2)) + bs
        if layer < CONTROLLER_LAYERS - 1:
            out = torch.relu(out)

    logits = out.reshape(b, n, h, w)
    up = mask_feat_stride // mask_out_stride
    return aligned_bilinear(logits, up) if up > 1 else logits
