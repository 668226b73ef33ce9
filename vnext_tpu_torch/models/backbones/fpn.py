"""Feature Pyramid Network on NCHW.

Counterpart of ``vnext_tpu.models.backbones.fpn`` (reference surface:
detectron2/modeling/backbone/fpn.py: lateral 1x1 and output 3x3 convolutions,
the nearest top-down pathway, the LastLevelMaxPool and LastLevelP6P7 blocks).
Module names follow the flax tree (``lateral_i``, ``output_i``, ``p6``, ``p7``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ...ops.interpolate import resize_nearest
from ..layers import Conv, ConvSame


class FPN(nn.Module):
    """{p2..p5 (+ p6, p7)} from the bottom-up features {res2..res5}; ``in_channels``
    are the channels of ``in_features``, finest first."""

    def __init__(self, in_channels: Sequence[int], in_features: Sequence[str] = ("res3", "res4", "res5"),
                 out_channels: int = 256, top_block: str = "maxpool", fuse_type: str = "sum",
                 dtype=torch.float32):
        super().__init__()
        if top_block not in ("maxpool", "p6p7", "none"):
            raise ValueError(f"FPN top_block {top_block!r}: 'maxpool', 'p6p7' or 'none'")
        if fuse_type not in ("sum", "avg"):
            raise ValueError(f"FPN fuse_type {fuse_type!r}: 'sum' or 'avg'")
        self.in_features = tuple(in_features)
        self.top_block, self.fuse_type = top_block, fuse_type
        c = out_channels
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral_{i}", Conv(cin, c, 1, dtype=dtype))
            self.add_module(f"output_{i}", Conv(c, c, 3, 1, 1, dtype=dtype))
        if top_block == "p6p7":
            self.p6 = ConvSame(in_channels[-1], c, 3, 2, dtype=dtype)
            self.p7 = ConvSame(c, c, 3, 2, dtype=dtype)

    def forward(self, bottom_up: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        feats = [bottom_up[f] for f in self.in_features]         # fine -> coarse
        lateral = [getattr(self, f"lateral_{i}")(x) for i, x in enumerate(feats)]
        results = [None] * len(lateral)
        prev = results[-1] = lateral[-1]
        for i in range(len(lateral) - 2, -1, -1):
            prev = lateral[i] + resize_nearest(prev, *lateral[i].shape[-2:])
            if self.fuse_type == "avg":
                prev = prev / 2
            results[i] = prev
        base = int(self.in_features[0][-1])                       # 'res2' -> 2
        outputs = {f"p{base + i}": getattr(self, f"output_{i}")(x) for i, x in enumerate(results)}
        top = base + len(results) - 1
        if self.top_block == "maxpool":
            # flax max_pool (1, 1) at stride 2, VALID: every other row and column
            outputs[f"p{top + 1}"] = outputs[f"p{top}"][..., ::2, ::2]
        elif self.top_block == "p6p7":
            p6 = self.p6(bottom_up[self.in_features[-1]])
            outputs[f"p{top + 1}"] = p6
            outputs[f"p{top + 2}"] = self.p7(torch.relu(p6))
        return outputs
