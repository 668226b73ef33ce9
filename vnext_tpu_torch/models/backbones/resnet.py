"""ResNet-18/34/50/101/152 trunk with frozen BN, returning the stages it is asked for (res3..res5 by default).

Counterpart of ``vnext_tpu.models.backbones.resnet.ResNet``: BasicBlock stages
(two 3x3 convolutions, no expansion) at depths 18 and 34, Bottleneck stages at
50, 101 and 152, in the torchvision layout (``stride_in_1x1=False``: the
stride sits on the 3x3) or the MSRA one (``stride_in_1x1=True``: on the first
1x1), which only the Bottleneck has. The
input is NHWC, as the JAX package's; inside, tensors are NCHW and, on the card,
in ``channels_last`` memory, which is the stem kernel's NHWC output as it is.
Outputs are NCHW.

The stem runs the hand-written kernel (``ops/stem_conv.py``) when the model
computes in bf16, the kernel's contract, as the JAX package runs its Pallas stem
only for bf16; an f32 model runs the f32 convolution, as the JAX package does.
An odd-sized image runs the kernel too: the stem's wrapper pads the odd side.

The Bottleneck stages take the JAX package's variants (detectron2's
resnet.py): ResNeXt's grouped 3x3 (``groups``, ``width_per_group``: the
first stage's width is ``(64 * width_per_group // 64) * groups``), DC5
(``res5_dilation`` 2: res5 at stride 1 with its 3x3 dilated by 2, so its
output stride is 16), and the deformable 3x3 of DCN v1 / v2 on the stages
``deform_on_per_stage`` names (``ops/deform_conv.py``: a zero-initialized
``conv2_offset`` convolution gives each tap's (dy, dx), and v2's
``deform_modulated`` its sigmoid modulation; the 3x3 weight is the raw HWIO
parameter ``conv2_weight``, as in the flax tree). ``build_resnet_backbone``
builds one from ``MODEL.RESNETS``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.deform_conv import deform_conv2d
from ...ops.stem_conv import stem_conv7x7s2_bn_relu
from ...utils.registry import Registry
from ..layers import Conv, FrozenBatchNorm

BACKBONE_REGISTRY = Registry("BACKBONE")

BLOCKS_PER_STAGE = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
                    152: (3, 8, 36, 3)}


class BasicBlock(nn.Module):
    """3x3 (stride) -> 3x3 with a residual; frozen BN (ResNet-18/34)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, dtype):
        super().__init__()
        self.conv1 = Conv(in_ch, out_ch, 3, stride, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(out_ch, dtype)
        self.conv2 = Conv(out_ch, out_ch, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = FrozenBatchNorm(out_ch, dtype)
        if in_ch != out_ch or stride != 1:
            self.downsample_conv = Conv(in_ch, out_ch, 1, stride, bias=False, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(out_ch, dtype)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation, groups; or deformable) -> 1x1 with a
    residual; frozen BN."""

    def __init__(self, in_ch: int, mid: int, out_ch: int, stride: int, dtype, stride_in_1x1: bool = False,
                 dilation: int = 1, groups: int = 1, deform: bool = False, deform_modulated: bool = False):
        super().__init__()
        stride_3x3 = 1 if stride_in_1x1 else stride
        self.stride_3x3, self.dilation, self.deform, self.deform_modulated = stride_3x3, dilation, deform, \
            deform_modulated
        self.conv1 = Conv(in_ch, mid, 1, stride if stride_in_1x1 else 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(mid, dtype)
        if deform:
            self.conv2_offset = Conv(mid, 27 if deform_modulated else 18, 3, stride_3x3, dilation, dtype=dtype,
                                     kernel_init="zeros", dilation=dilation)
            self.conv2_weight = nn.Parameter(torch.empty(3, 3, mid, mid))      # HWIO, as the flax tree holds it
        else:
            self.conv2 = Conv(mid, mid, 3, stride_3x3, dilation, bias=False, dtype=dtype, dilation=dilation,
                              groups=groups)
        self.bn2 = FrozenBatchNorm(mid, dtype)
        self.conv3 = Conv(mid, out_ch, 1, bias=False, dtype=dtype)
        self.bn3 = FrozenBatchNorm(out_ch, dtype)
        if in_ch != out_ch or stride != 1:
            self.downsample_conv = Conv(in_ch, out_ch, 1, stride, bias=False, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(out_ch, dtype)
        else:
            self.downsample_conv = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        """``conv2_weight`` by flax's he_normal (the convolutions init themselves)."""
        if self.deform:
            std = math.sqrt(2.0 / (9 * self.conv2_weight.shape[2])) / 0.87962566103423978
            nn.init.trunc_normal_(self.conv2_weight, 0.0, std, -2 * std, 2 * std, generator=gen)

    def deform_conv(self, x: torch.Tensor) -> torch.Tensor:
        """The deformable 3x3 on NCHW ``x``: offsets (and v2's modulation) from
        ``conv2_offset``, the samples contracted in f32, cast back to x's dtype."""
        off = self.conv2_offset(x).permute(0, 2, 3, 1)
        modulation = None
        if self.deform_modulated:
            off, modulation = off[..., :18], torch.sigmoid(off[..., 18:])
        d = self.dilation
        out = deform_conv2d(x.permute(0, 2, 3, 1), off, self.conv2_weight, stride=self.stride_3x3, padding=d,
                            dilation=d, modulation=modulation)
        return out.to(x.dtype).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.deform_conv(out) if self.deform else self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample_conv is None else self.downsample_bn(self.downsample_conv(x))
        return torch.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, dtype=torch.float32,
                 out_features: Sequence[str] = ("res3", "res4", "res5"), stride_in_1x1: bool = False,
                 res5_dilation: int = 1, groups: int = 1, width_per_group: int = 64,
                 deform_on_per_stage: Sequence[bool] = (False, False, False, False), deform_modulated: bool = False):
        super().__init__()
        if depth not in BLOCKS_PER_STAGE:
            raise ValueError(f"the port has ResNet depths {sorted(BLOCKS_PER_STAGE)}, got {depth}")
        unknown = set(out_features) - {"res2", "res3", "res4", "res5"}
        if unknown:
            raise ValueError(f"ResNet has no outputs {sorted(unknown)}")
        self.dtype = dtype
        self.depth = depth
        self.out_features = tuple(out_features)
        self.res5_dilation = res5_dilation
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(64, dtype)
        basic = depth < 50
        # torchvision / ResNeXt bottleneck width: planes * width_per_group / 64 * groups
        in_ch, mid, out_ch = 64, (64 * width_per_group // 64) * groups, 64 if basic else 256
        self.stage_blocks = []
        for stage, n in enumerate(BLOCKS_PER_STAGE[depth]):
            first_stride, dilation = (2 if stage > 0 else 1), 1
            if stage == 3 and res5_dilation == 2:
                first_stride, dilation = 1, 2
            names = []
            for i in range(n):
                name = f"layer{stage + 1}_{i}"
                stride = first_stride if i == 0 else 1
                block = (BasicBlock(in_ch, out_ch, stride, dtype) if basic
                         else Bottleneck(in_ch, mid, out_ch, stride, dtype, stride_in_1x1, dilation, groups,
                                         deform_on_per_stage[stage], deform_modulated))
                self.add_module(name, block)
                names.append(name)
                in_ch = out_ch
            self.stage_blocks.append(names)
            mid, out_ch = mid * 2, out_ch * 2

    @property
    def output_strides(self) -> Dict[str, int]:
        return {"res2": 4, "res3": 8, "res4": 16, "res5": 16 if self.res5_dilation == 2 else 32}

    @property
    def output_channels(self) -> Dict[str, int]:
        if self.depth < 50:  # BasicBlock stages have no 4x expansion
            return {"res2": 64, "res3": 128, "res4": 256, "res5": 512}
        return {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}

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


@BACKBONE_REGISTRY.register()
def build_resnet_backbone(cfg, dtype=torch.float32) -> ResNet:
    """The ResNet of ``MODEL.RESNETS``: the keys the JAX package's builder
    reads (DEPTH, OUT_FEATURES, RES5_DILATION, STRIDE_IN_1X1) and no other.
    Its outputs are ``OUT_FEATURES`` and res2, the keys the JAX package's
    ResNet returns (it always adds res2)."""
    r = cfg.MODEL.RESNETS
    features = tuple(sorted(set(r.OUT_FEATURES) | {"res2"}))
    return ResNet(r.DEPTH, dtype, out_features=features, stride_in_1x1=r.STRIDE_IN_1X1,
                  res5_dilation=r.RES5_DILATION)
