"""RegNet trunk: a 3x3 / 2 stem and four stages of ResBottleneckBlocks.

Counterpart of ``vnext_tpu.models.backbones.regnet`` (reference surface:
detectron2/modeling/backbone/regnet.py: SimpleStem and the AnyNet of
ResBottleneckBlocks with the RegNetX / RegNetY quantized-linear widths;
RegNetY adds squeeze-excitation). The widths, depths and group widths come
from (w_a, w_0, w_m, depth, group_width) by ``generate_regnet_params``, the
"Designing Network Design Spaces" recipe, in numpy as the JAX package's.

The input is NHWC and the outputs are NCHW, as ``resnet.ResNet``'s; the
stages are res2..res5 at strides 4..32, so the trunk drops in wherever a
ResNet feeds an FPN. The stem is a 3x3 convolution, so no hand-written kernel
runs on this trunk.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..layers import Conv, FrozenBatchNorm


def generate_regnet_params(w_a: float, w_0: int, w_m: float, depth: int, group_width: int,
                           q: int = 8) -> Tuple[list, list, list]:
    """Per-stage (widths, depths, group_widths) from the RegNet formula."""
    u = w_0 + w_a * np.arange(depth)
    s = np.round(np.log(u / w_0) / np.log(w_m))
    widths = (np.round(w_0 * np.power(w_m, s) / q) * q).astype(int)
    stage_widths, stage_depths = [], []
    for w in widths:
        if stage_widths and stage_widths[-1] == w:
            stage_depths[-1] += 1
        else:
            stage_widths.append(int(w))
            stage_depths.append(1)
    gws = [min(group_width, w) for w in stage_widths]
    stage_widths = [int(round(w / g) * g) for w, g in zip(stage_widths, gws)]
    return stage_widths, stage_depths, gws


# (w_a, w_0, w_m, depth, group_width, se): the standard configurations
REGNET_CONFIGS = {
    "RegNetX-400MF": (24.48, 24, 2.54, 22, 16, False),
    "RegNetX-1.6GF": (34.01, 80, 2.25, 18, 24, False),
    "RegNetX-4GF": (38.65, 96, 2.43, 23, 40, False),
    "RegNetX-8GF": (49.56, 80, 2.88, 23, 120, False),
    "RegNetY-400MF": (27.89, 48, 2.09, 16, 8, True),
    "RegNetY-1.6GF": (20.71, 48, 2.65, 27, 24, True),
    "RegNetY-4GF": (31.41, 96, 2.24, 22, 64, True),
    "RegNetY-8GF": (76.82, 192, 2.19, 17, 56, True),
}


class SqueezeExcite(nn.Module):
    """x * sigmoid(fc2(relu(fc1(mean over H, W of x)))); fc1 / fc2 are 1x1
    convolutions with biases."""

    def __init__(self, channels: int, se_channels: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Conv(channels, se_channels, 1, dtype=dtype)
        self.fc2 = Conv(se_channels, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))


class ResBottleneckBlock(nn.Module):
    """1x1 -> grouped 3x3 (stride) [-> SE] -> 1x1 with a residual, bottleneck
    ratio 1; frozen BN. The SE width is a quarter of the block's input width."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, group_width: int = 16, se_ratio: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        w_b = out_ch
        groups = max(w_b // group_width, 1)
        self.a = Conv(in_ch, w_b, 1, bias=False, dtype=dtype)
        self.a_bn = FrozenBatchNorm(w_b, dtype)
        self.b = Conv(w_b, w_b, 3, stride, 1, bias=False, dtype=dtype, groups=groups)
        self.b_bn = FrozenBatchNorm(w_b, dtype)
        self.se = SqueezeExcite(w_b, max(int(in_ch * se_ratio), 1), dtype) if se_ratio > 0 else None
        self.c = Conv(w_b, out_ch, 1, bias=False, dtype=dtype)
        self.c_bn = FrozenBatchNorm(out_ch, dtype)
        if in_ch != out_ch or stride != 1:
            self.proj = Conv(in_ch, out_ch, 1, stride, bias=False, dtype=dtype)
            self.proj_bn = FrozenBatchNorm(out_ch, dtype)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.a_bn(self.a(x)))
        out = torch.relu(self.b_bn(self.b(out)))
        if self.se is not None:
            out = self.se(out)
        out = self.c_bn(self.c(out))
        identity = x if self.proj is None else self.proj_bn(self.proj(x))
        return torch.relu(out + identity)


class RegNet(nn.Module):
    """Four-stage RegNet trunk producing ``out_features`` of res2..res5."""

    def __init__(self, variant: str = "RegNetX-4GF", out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 stem_channels: int = 32, dtype=torch.float32):
        super().__init__()
        if variant not in REGNET_CONFIGS:
            raise ValueError(f"unknown RegNet variant {variant!r}; known: {sorted(REGNET_CONFIGS)}")
        self.variant, self.out_features, self.dtype = variant, tuple(out_features), dtype
        widths, depths, gws, se = self.stage_params
        self.stem = Conv(3, stem_channels, 3, 2, 1, bias=False, dtype=dtype)
        self.stem_bn = FrozenBatchNorm(stem_channels, dtype)
        in_ch = stem_channels
        self.stage_blocks = []
        for i, (w, d, g) in enumerate(zip(widths, depths, gws)):
            names = []
            for b in range(d):
                name = f"s{i + 1}_b{b}"
                self.add_module(name, ResBottleneckBlock(in_ch, w, 2 if b == 0 else 1, g, 0.25 if se else 0.0,
                                                         dtype))
                names.append(name)
                in_ch = w
            self.stage_blocks.append(names)

    @property
    def stage_params(self):
        w_a, w_0, w_m, depth, gw, se = REGNET_CONFIGS[self.variant]
        widths, depths, gws = generate_regnet_params(w_a, w_0, w_m, depth, gw)
        if len(widths) != 4:
            raise ValueError(f"{self.variant}: got {len(widths)} stages")
        return widths, depths, gws, se

    @property
    def output_channels(self) -> Dict[str, int]:
        return {f"res{i + 2}": w for i, w in enumerate(self.stage_params[0])}

    @property
    def output_strides(self) -> Dict[str, int]:
        return {"res2": 4, "res3": 8, "res4": 16, "res5": 32}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [B, H, W, 3] normalized; returns the ``out_features`` NCHW (every
        stage runs, as in the JAX package)."""
        y = x.permute(0, 3, 1, 2)
        if y.is_cuda:
            y = y.contiguous(memory_format=torch.channels_last)
        y = torch.relu(self.stem_bn(self.stem(y)))
        outputs = {}
        for i, names in enumerate(self.stage_blocks):
            for name in names:
                y = getattr(self, name)(y)
            if f"res{i + 2}" in self.out_features:
                outputs[f"res{i + 2}"] = y
        return outputs
