"""ResNet stem: 7x7/s2 conv (3 -> 64 channels) + frozen-BN affine + ReLU, NHWC.

Counterpart of ``vnext_tpu.ops.stem_conv.stem_conv7x7s2_bn_relu``: the input and
the kernel are rounded to bf16, products are summed in f32, and the output is
bf16 ``relu(conv(x, k) * scale + bias)`` of shape [B, H/2, W/2, 64] for even H, W.

The forward is the operator ``torch.ops.vnext.stem_conv`` (so that
``torch.export`` keeps it in a graph): on a CPU tensor it runs
:func:`stem_conv_plain`; on a CUDA tensor the hand-written kernel
``csrc/stem_conv.cu`` or it raises. The kernel is an implicit GEMM on the
tensor cores whose reduction axis K runs over (ky, kx, ci) as 7 runs of 21
values, each run padded to 22 and K to 160: :func:`pack_stem_weights` lays the
weights out in that order. Either way the op is a ``torch.autograd.Function``
whose backward is the autograd of :func:`stem_conv_ref_f32` at the same inputs,
as the JAX package's custom VJP linearizes ``_stem_ref_f32``: there is no
backward kernel on the TPU either.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import register_flop_formula

from .._build import Kernel, check, load_library, stream_handle

KERNEL = Kernel(
    name="stem_conv",
    source="vnext_tpu_torch/csrc/stem_conv.cu",
    replaces="vnext_tpu/ops/stem_conv.py:91",
)


# the kernel's reduction order: k = ky * K_RUN_PAD + kx * 3 + ci; column
# ky * K_RUN_PAD + K_RUN of each run and the columns from 7 * K_RUN_PAD are zero
K_RUN, K_RUN_PAD, K_PAD = 21, 22, 160


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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stem_conv: no implementation for device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, k_hwio, scale, bias)):
        return _StemConv.apply(x, k_hwio, scale, bias)
    # no gradient wanted (serving, a frozen stem): the forward alone, without
    # autograd's bookkeeping, which at the train shape costs the host about as
    # much time as the kernel takes on the card (PERF.md)
    return _forward(x, k_hwio, scale, bias)


def _forward(x, k_hwio, scale, bias):
    return stem_conv_op(x, k_hwio, scale, bias)


@torch.library.custom_op("vnext::stem_conv", mutates_args=(), device_types="cpu")
def stem_conv_op(x: torch.Tensor, k_hwio: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """The stem as an operator: the plain version on the CPU, K2 on the card
    (registered below); bf16 [B, H/2, W/2, 64]."""
    return stem_conv_plain(x, k_hwio, scale, bias)


@stem_conv_op.register_kernel("cuda")
def _stem_conv_cuda(x, k_hwio, scale, bias):
    return _launch(x, k_hwio, scale, bias)


@stem_conv_op.register_fake
def _stem_conv_fake(x, k_hwio, scale, bias):
    _check_args(x, k_hwio, scale, bias)
    b, h, w, _ = x.shape
    return x.new_empty(b, h // 2, w // 2, 64, dtype=torch.bfloat16)


@register_flop_formula(torch.ops.vnext.stem_conv)
def stem_conv_flops(x_shape, *args, **kwargs) -> int:
    """2 operations per multiply-add of the 7x7 convolution (3 -> 64 channels)
    at each output pixel; the affine and the ReLU are not counted."""
    b, h, w, _ = x_shape
    return 2 * b * (h // 2) * (w // 2) * 64 * 7 * 7 * 3


class _StemConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k_hwio, scale, bias):
        ctx.save_for_backward(x, k_hwio, scale, bias)
        return _forward(x, k_hwio, scale, bias)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs, ctx.needs_input_grad)]
            wanted = [leaf for leaf in leaves if leaf.requires_grad]
            grads = iter(torch.autograd.grad(stem_conv_ref_f32(*leaves), wanted, grad.float()))
        return tuple(next(grads) if need else None for need in ctx.needs_input_grad)


def stem_conv_ref_f32(x, k_hwio, scale, bias) -> torch.Tensor:
    """The backward's linearization point (JAX ``_stem_ref_f32``): an f32
    convolution of x with the bf16-rounded kernel, the affine and the ReLU, in
    f32. The kernel's gradient is rounded to bf16, as JAX's is (it enters the
    op as bf16)."""
    xf = x.float().permute(0, 3, 1, 2)
    kb = k_hwio.to(torch.bfloat16).float().permute(3, 2, 0, 1)   # OIHW
    y = F.conv2d(xf, kb, stride=2, padding=3)
    y = y * scale.float()[None, :, None, None] + bias.float()[None, :, None, None]
    return torch.relu(y).permute(0, 2, 3, 1)


def stem_conv_plain(x, k_hwio, scale, bias) -> torch.Tensor:
    """Plain PyTorch version: an f32 convolution of the bf16-rounded operands."""
    _check_args(x, k_hwio, scale, bias)
    xb = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    kb = k_hwio.to(torch.bfloat16).float().permute(3, 2, 0, 1)   # OIHW
    y = F.conv2d(xb, kb, stride=2, padding=3)
    y = y * scale.float()[None, :, None, None] + bias.float()[None, :, None, None]
    return torch.relu(y).to(torch.bfloat16).permute(0, 2, 3, 1)


def pack_stem_weights(k_hwio) -> torch.Tensor:
    """HWIO [7, 7, 3, 64] -> bf16 [64, K_PAD]: row n holds k_hwio[ky, kx, ci, n] at
    column ky * K_RUN_PAD + kx * 3 + ci (the kernel's K order), zeros elsewhere."""
    if k_hwio.shape != (7, 7, 3, 64):
        raise ValueError(f"stem kernel must be [7, 7, 3, 64] (HWIO), got {tuple(k_hwio.shape)}")
    packed = torch.zeros(64, K_PAD, dtype=torch.bfloat16, device=k_hwio.device)
    runs = packed[:, :7 * K_RUN_PAD].view(64, 7, K_RUN_PAD)
    runs[:, :, :K_RUN] = k_hwio.reshape(7, K_RUN, 64).permute(2, 0, 1)   # rounds to bf16
    return packed


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
    if x.data_ptr() % 16:
        raise ValueError("the stem kernel reads its input in 16-byte loads: the input must be 16-byte aligned")
    wgt = pack_stem_weights(k_hwio)
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
