"""ResNet stem: 7x7/s2 conv (3 -> 64 channels) + frozen-BN affine + ReLU, NHWC.

Counterpart of ``vnext_tpu.ops.stem_conv.stem_conv7x7s2_bn_relu``: the input and
the kernel are rounded to bf16, products are summed in f32, and the output is
bf16 ``relu(conv(x, k) * scale + bias)`` of shape [B, H/2, W/2, 64] for even H, W.

A CPU tensor runs :func:`stem_conv_plain`; a CUDA tensor runs the hand-written
kernel ``csrc/stem_conv.cu`` or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._build import Kernel, check, load_library, stream_handle

KERNEL = Kernel(
    name="stem_conv",
    source="vnext_tpu_torch/csrc/stem_conv.cu",
    replaces="vnext_tpu/ops/stem_conv.py:91",
)


def _check_args(x, k_hwio, scale, bias):
    if x.dim() != 4 or x.shape[-1] != 3 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"stem input must be [B, H, W, 3] with H, W even, got {tuple(x.shape)}")
    if k_hwio.shape != (7, 7, 3, 64):
        raise ValueError(f"stem kernel must be [7, 7, 3, 64] (HWIO), got {tuple(k_hwio.shape)}")
    if scale.shape != (64,) or bias.shape != (64,):
        raise ValueError("stem scale and bias must be [64]")


def stem_conv7x7s2_bn_relu(x, k_hwio, scale, bias) -> torch.Tensor:
    """x [B, H, W, 3] (any float dtype), k_hwio [7, 7, 3, 64], scale/bias [64] f32.
    Returns bf16 [B, H/2, W/2, 64]."""
    _check_args(x, k_hwio, scale, bias)
    if x.device.type == "cpu":
        return stem_conv_plain(x, k_hwio, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"stem_conv: no implementation for device {x.device}")
    return _launch(x, k_hwio, scale, bias)


def stem_conv_plain(x, k_hwio, scale, bias) -> torch.Tensor:
    """Plain PyTorch version: an f32 convolution of the bf16-rounded operands."""
    _check_args(x, k_hwio, scale, bias)
    xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    kb = k_hwio.to(torch.bfloat16).float().permute(3, 2, 0, 1)   # OIHW
    y = F.conv2d(xb, kb, stride=2, padding=3)
    y = y * scale.float()[None, :, None, None] + bias.float()[None, :, None, None]
    return torch.relu(y).to(torch.bfloat16).permute(0, 2, 3, 1)


def _launch(x, k_hwio, scale, bias):
    b, h, w, _ = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("the stem kernel takes a contiguous float32 NHWC input")
    if b > 65535:
        raise ValueError(f"the stem kernel puts the batch on grid z (<= 65535), got {b}")
    for name, t in (("kernel", k_hwio), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"stem {name} is on {t.device}, input on {x.device}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("the stem kernel takes scale and bias as float32")
    wgt = k_hwio.to(torch.bfloat16).contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    out = torch.empty(b, h // 2, w // 2, 64, dtype=torch.bfloat16, device=x.device)
    lib = load_library().lib
    with torch.cuda.device(x.device):
        code = lib.vnext_stem_conv(
            x.data_ptr(), wgt.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, w, stream_handle(x.device),
        )
    check(code, "stem_conv")
    KERNEL.launches += 1
    return out
