"""ResNet-50 trunk with frozen BN, returning the stages it is asked for (res3..res5 by default).

Counterpart of ``vnext_tpu.models.backbones.resnet.ResNet`` at depth 50 with the
torchvision layout (``stride_in_1x1=False``: the stride sits on the 3x3). The
input is NHWC, as the JAX package's; inside, tensors are NCHW and, on the card,
in ``channels_last`` memory, which is the stem kernel's NHWC output as it is.
Outputs are NCHW.

The stem runs the hand-written kernel (``ops/stem_conv.py``) when the model
computes in bf16, the kernel's contract, as the JAX package runs its Pallas stem
only for bf16; an f32 model runs the f32 convolution, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.stem_conv import stem_conv7x7s2_bn_relu
from ..layers import Conv, FrozenBatchNorm

BLOCKS_PER_STAGE = {50: (3, 4, 6, 3)}


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 with a residual; frozen BN."""

    def __init__(self, in_ch: int, mid: int, out_ch: int, stride: int, dtype):
        super().__init__()
        self.conv1 = Conv(in_ch, mid, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(mid, dtype)
        self.conv2 = Conv(mid, mid, 3, stride, 1, bias=False, dtype=dtype)
        self.bn2 = FrozenBatchNorm(mid, dtype)
        self.conv3 = Conv(mid, out_ch, 1, bias=False, dtype=dtype)
        self.bn3 = FrozenBatchNorm(out_ch, dtype)
        if in_ch != out_ch or stride != 1:
            self.downsample_conv = Conv(in_ch, out_ch, 1, stride, bias=False, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(out_ch, dtype)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return torch.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, dtype=torch.float32,
                 out_features: Sequence[str] = ("res3", "res4", "res5")):
        super().__init__()
        if depth not in BLOCKS_PER_STAGE:
            raise ValueError(f"the port has ResNet depths {sorted(BLOCKS_PER_STAGE)}, got {depth}")
        unknown = set(out_features) - {"res2", "res3", "res4", "res5"}
        if unknown:
            raise ValueError(f"ResNet has no outputs {sorted(unknown)}")
        self.dtype = dtype
        self.out_features = tuple(out_features)
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64, dtype)
        in_ch, mid, out_ch = 64, 64, 256
        self.stage_blocks = []
        for stage, n in enumerate(BLOCKS_PER_STAGE[depth]):
            names = []
            for i in range(n):
                name = f"layer{stage + 1}_{i}"
                stride = 2 if (stage > 0 and i == 0) else 1
                self.add_module(name, Bottleneck(in_ch, mid, out_ch, stride, dtype))
                names.append(name)
                in_ch = out_ch
            self.stage_blocks.append(names)
            mid, out_ch = mid * 2, out_ch * 2

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input -> NCHW stride-2 activation (before the max-pool)."""
        if self.dtype == torch.bfloat16:
            scale, shift = self.bn1.folded()
            k_hwio = self.conv1.weight.permute(2, 3, 1, 0)
            return stem_conv7x7s2_bn_relu(x, k_hwio, scale, shift).permute(0, 3, 1, 2)
        y = self.conv1(x.permute(0, 3, 1, 2))
        return torch.relu(self.bn1(y))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [B, H, W, 3] normalized; returns the ``out_features`` NCHW. Every
        stage holds its parameters (the flax tree has them all), but the stages
        after the last output are not run."""
        y = self.stem(x)
        if y.is_cuda:
            y = y.contiguous(memory_format=torch.channels_last)
        # max-pool 3x3/s2 with -inf padding, as flax nn.max_pool pads
        y = F.max_pool2d(y, 3, 2, 1)
        outputs = {}
        last = max(int(name[3:]) for name in self.out_features) - 2
        for stage, names in enumerate(self.stage_blocks[:last + 1]):
            for name in names:
                y = getattr(self, name)(y)
            if f"res{stage + 2}" in self.out_features:
                outputs[f"res{stage + 2}"] = y
        return outputs
