"""Shared building blocks: Dense, Conv (also flax's "SAME" and transposed forms), norms (SyncBatchNorm
among them), MLP, ConvGN, MultiHeadAttention, ASPP, dropout.

Counterpart of ``vnext_tpu.models.layers``. Every module holds f32 parameters and
computes in its ``dtype`` (bf16 on the card, f32 in the CPU tests), casting the
parameters at use as flax does. Norm statistics are f32. Parameter names follow
the flax tree (``weight`` for a kernel or a norm scale, ``bias``), so weights
bridge from the JAX package mechanically (``checkpoint/from_jax.py``).

Parameters are created uninitialized; :func:`init_weights` fills every module's
own parameters from one seeded ``torch.Generator`` with the JAX package's init
schemes (lecun-normal kernels, zero biases, unit norm scales, and the special
initializers the modules name).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.encoder_epilogue import EPS as LN_EPS, layer_norm_f32

GN_EPS = 1e-6   # flax's GroupNorm default, not torch's 1e-5
BN_EPS = 1e-5   # frozen BN, as the reference checkpoints were trained


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: keep each element with probability
    1 - rate and scale the kept ones by 1 / (1 - rate), in x's dtype. The draws
    come from ``generator`` (on x's device; the default generator when None).
    They are not the TPU's bits, so parity with the JAX package holds at rate 0."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp_min(eps) / (1 - x).clamp_min(eps))


# ---------------------------------------------------------------- initializers
def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: truncated normal (2 sigma) of variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    nn.init.uniform_(t, -bound, bound, generator=gen)


def _kernel_init(t: torch.Tensor, kind: str, fan_in: int, fan_out: int, gen) -> None:
    if kind == "lecun":
        lecun_normal_(t, fan_in, gen)
    elif kind == "xavier":
        _uniform_(t, math.sqrt(6.0 / (fan_in + fan_out)), gen)
    elif kind == "kaiming":
        _uniform_(t, math.sqrt(6.0 / fan_in), gen)
    elif kind == "zeros":
        nn.init.zeros_(t)
    else:
        raise ValueError(f"unknown kernel init {kind!r}")


def init_weights(module: nn.Module, seed: int) -> None:
    """Initialize every parameter of ``module`` from one seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)


def _empty(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32))


# ---------------------------------------------------------------- layers
class Dense(nn.Module):
    """Linear layer (flax nn.Dense): weight [out, in], bias [out] unless ``bias=False``."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32,
                 kernel_init: str = "lecun",
                 bias_init: Optional[Callable[[torch.Tensor], None]] = None, bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel_init = kernel_init
        self.bias_init = bias_init
        self.weight = _empty(out_features, in_features)
        self.bias = _empty(out_features) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        out_f, in_f = self.weight.shape
        _kernel_init(self.weight, self.kernel_init, in_f, out_f, gen)
        if self.bias is None:
            return
        if self.bias_init is None:
            nn.init.zeros_(self.bias)
        else:
            self.bias_init(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv(nn.Module):
    """2-d convolution on NCHW (flax nn.Conv with symmetric padding): weight OIHW,
    [out, in / groups, kh, kw] for a grouped one (flax's ``feature_group_count``,
    whose HWIO kernel is [kh, kw, in / groups, out])."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, dtype=torch.float32,
                 kernel_init: str = "lecun", bias_init: Optional[Callable[[torch.Tensor], None]] = None,
                 dilation: int = 1, groups: int = 1):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self.kernel_init = kernel_init
        self.bias_init = bias_init
        self.weight = _empty(out_ch, in_ch // groups, kernel_size, kernel_size)
        self.bias = _empty(out_ch) if bias else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        o, i, kh, kw = self.weight.shape
        _kernel_init(self.weight, self.kernel_init, i * kh * kw, o * kh * kw, gen)
        if self.bias is None:
            return
        if self.bias_init is None:
            nn.init.zeros_(self.bias)
        else:
            self.bias_init(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding, self.dilation, self.groups)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax / XLA "SAME" padding of one axis: (before, after), output ceil(size / s)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class ConvSame(Conv):
    """``Conv`` with flax's "SAME" padding, which is asymmetric for an even
    size at stride 2 (0 before, 1 after for a 3-tap kernel)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride, 0, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.weight.shape[-1], self.stride
        (t, b), (l, r) = same_pads(x.shape[-2], k, s), same_pads(x.shape[-1], k, s)
        return super().forward(F.pad(x, (l, r, t, b)))


class ConvTranspose(Conv):
    """flax ``nn.ConvTranspose(padding="SAME")`` with its default
    ``transpose_kernel=False``: the input dilated by the stride and padded as
    ``lax.conv_transpose`` pads "SAME" (k - 1 before for stride 2, k // 2 for
    stride 1), then correlated with the kernel as it is, with no spatial flip
    and no in/out swap. The output side is input * stride. ``weight`` is the
    bridge's layout of the flax kernel (kh, kw, in, out): [out, in, kh, kw].

    It runs as ``conv_transpose2d`` with padding 0, which pads k - 1 on both
    sides, on the kernel flipped and swapped to torch's convention, and keeps
    the window that ``lax.conv_transpose``'s own padding selects."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1, dtype=torch.float32):
        super().__init__(in_ch, out_ch, kernel_size, stride, 0, dtype=dtype)

    @staticmethod
    def lax_pads(k: int, s: int) -> Tuple[int, int]:
        """``lax.conv_transpose``'s "SAME" padding of the dilated input."""
        pad_len = k + s - 2
        before = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
        return before, pad_len - before

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, k, s = self.dtype, self.weight.shape[-1], self.stride
        before, after = self.lax_pads(k, s)
        if before > k - 1 or after > k - 1:
            raise ValueError(f"ConvTranspose: kernel {k} at stride {s} pads beyond k - 1")
        w = self.weight.to(dt).flip(-2, -1).transpose(0, 1)           # [in, out, kh, kw]
        y = F.conv_transpose2d(x.to(dt), w, None if self.bias is None else self.bias.to(dt), s)
        lo = k - 1 - before                       # conv_transpose2d pads k - 1 before
        h, wd = ((n - 1) * s + before + after - k + 2 for n in x.shape[-2:])
        return y[..., lo:lo + h, lo:lo + wd]


class LayerNorm(nn.Module):
    """flax nn.LayerNorm (eps 1e-6): f32 statistics, output in ``dtype``."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = _empty(features)
        self.bias = _empty(features)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_f32(x, self.weight, self.bias, LN_EPS).to(self.dtype)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm on NCHW (eps 1e-6, not torch's 1e-5): f32 statistics."""

    def __init__(self, num_groups: int, features: int, dtype=torch.float32):
        super().__init__()
        self.num_groups, self.dtype = num_groups, dtype
        self.weight = _empty(features)
        self.bias = _empty(features)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        xg = x.float().reshape(b, self.num_groups, -1)
        mu = xg.mean(-1, keepdim=True)
        var = ((xg * xg).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
        y = ((xg - mu) * torch.rsqrt(var + GN_EPS)).reshape(b, c, h, w)
        y = y * self.weight.float()[:, None, None] + self.bias.float()[:, None, None]
        return y.to(self.dtype)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics (eps 1e-5), folded into one f32 scale and
    shift that are cast to ``dtype`` before use, as the JAX package does.

    All four tensors are parameters, as in the flax tree: the optimizer never
    updates them (``solver.build.frozen_mask``), but they carry gradients, which
    the full-model gradient-norm clip counts as the JAX package's does."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        for name in ("weight", "bias", "running_mean", "running_var"):
            setattr(self, name, _empty(features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def folded(self):
        """(scale, shift) in f32."""
        inv = self.weight * torch.rsqrt(self.running_var + BN_EPS)
        return inv, self.bias - self.running_mean * inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, shift = self.folded()
        dt = self.dtype
        return x * scale.to(dt)[:, None, None] + shift.to(dt)[:, None, None]


class MLP(nn.Module):
    """ReLU MLP with layers ``layers_0 .. layers_{n-1}``."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, num_layers: int,
                 dtype=torch.float32, final_kernel_init: str = "lecun",
                 final_bias_init: Optional[Callable[[torch.Tensor], None]] = None):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"layers_{i}", Dense(
                dims[i], dims[i + 1], dtype,
                kernel_init=final_kernel_init if last else "lecun",
                bias_init=final_bias_init if last else None,
            ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x


class ConvGN(nn.Module):
    """Conv (xavier init, with bias) + GroupNorm(32): the DETR input projection."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 1, stride: int = 1,
                 num_groups: int = 32, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(in_ch, features, kernel_size, stride, kernel_size // 2,
                         dtype=dtype, kernel_init="xavier")
        self.norm = GroupNorm(num_groups, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv(x))


class MultiHeadAttention(nn.Module):
    """Softmax MHA (decoder self- and masked cross-attention): separate q/k/v/out
    projections, the logits and the softmax in f32, written as explicit products."""

    def __init__(self, d_model: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, Dense(d_model, d_model, dtype))

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask`` (broadcast to [B, H, Q, K]) is True where a query may attend:
        elsewhere its f32 logit becomes -1e9 before the softmax, as JAX's."""
        b, nq, d = q.shape
        h = self.num_heads
        hd = d // h
        qp = self.q_proj(q).view(b, nq, h, hd).transpose(1, 2)          # [B, H, Q, hd]
        kp = self.k_proj(k).view(b, k.shape[1], h, hd).transpose(1, 2)
        vp = self.v_proj(v).view(b, v.shape[1], h, hd).transpose(1, 2)
        logits = torch.matmul(qp, kp.transpose(-1, -2)).float() / math.sqrt(hd)
        if mask is not None:
            logits = logits.masked_fill(~mask, -1e9)
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.matmul(attn, vp).transpose(1, 2).reshape(b, nq, d)
        return self.out_proj(out)


class _BatchNormState(nn.Module):
    """flax ``nn.BatchNorm``'s variables under its name: the ``weight`` (flax's
    ``scale``) and ``bias`` parameters and the ``mean`` / ``var`` running
    statistics (flax's ``batch_stats``) as buffers."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = _empty(features)
        self.bias = _empty(features)
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)


class _AllReduce(torch.autograd.Function):
    """A sum over the ranks whose gradient is the sum of the ranks' gradients
    (detectron2's ``AllReduce``)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class SyncBatchNorm(nn.Module):
    """Batch normalization over the channel axis (dim 1: [N, C] or [N, C, H,
    W]) with the statistics of the batch across every rank of ``group``.

    Counterpart of ``vnext_tpu.models.layers.SyncBatchNorm`` (flax's
    ``nn.BatchNorm`` with an ``axis_name``; detectron2's
    ``NaiveSyncBatchNorm``): in train mode each rank takes the per-channel mean
    and mean of squares of its batch, one ``all_reduce`` averages them over
    the ranks (each rank holds the same batch size), and the variance is their
    difference, as flax computes it. The running statistics move as flax's
    do: ``momentum * old + (1 - momentum) * batch``, with the biased variance.
    Without a process group it is plain batch norm; with
    ``use_running_average`` it normalizes by the running statistics and
    communicates nothing. f32 statistics, output in ``dtype``. Not
    ``torch.nn.SyncBatchNorm``, which takes CUDA tensors only."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = BN_EPS, dtype=torch.float32,
                 group=None):
        super().__init__()
        self.momentum, self.eps, self.dtype, self.group = momentum, eps, dtype, group
        self.bn = _BatchNormState(features)

    def forward(self, x: torch.Tensor, use_running_average: bool = False) -> torch.Tensor:
        import torch.distributed as dist

        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.float()
        if use_running_average:
            mean, var = self.bn.mean, self.bn.var
        else:
            dims = [d for d in range(x.dim()) if d != 1]
            stats = torch.stack([xf.mean(dims), (xf * xf).mean(dims)])
            if dist.is_available() and dist.is_initialized():
                stats = _AllReduce.apply(stats, self.group) / dist.get_world_size(self.group)
            mean, mean2 = stats.unbind()
            var = (mean2 - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.bn.mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.bn.var.mul_(m).add_((1.0 - m) * var.detach())
        y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
        y = y * self.bn.weight.float().reshape(shape) + self.bn.bias.float().reshape(shape)
        return y.to(self.dtype)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling (detectron2's layers/aspp.py:14): a 1x1
    branch, one 3x3 branch for each dilation, and a branch that pools the whole
    map, each a bias-free convolution with ReLU, concatenated and projected by
    a 1x1 convolution with ReLU. Counterpart of ``vnext_tpu.models.layers.ASPP``:
    NHWC in and out, as the JAX module; the convolutions run NCHW inside."""

    def __init__(self, in_channels: int, out_channels: int, dilations: Tuple[int, ...] = (6, 12, 18),
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        c = out_channels
        self.conv1x1 = Conv(in_channels, c, 1, bias=False, dtype=dtype)
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            self.add_module(f"conv3x3_d{i}", Conv(in_channels, c, 3, padding=d, dilation=d, bias=False, dtype=dtype))
        self.pool_conv = Conv(in_channels, c, 1, bias=False, dtype=dtype)
        self.project = Conv(c * (len(self.dilations) + 2), c, 1, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C_in] -> [B, H, W, C_out]."""
        x = x.permute(0, 3, 1, 2)
        branches = [torch.relu(self.conv1x1(x))]
        branches += [torch.relu(getattr(self, f"conv3x3_d{i}")(x)) for i in range(len(self.dilations))]
        pooled = torch.relu(self.pool_conv(x.mean((2, 3), keepdim=True)))
        branches.append(pooled.expand(-1, -1, *x.shape[2:]))
        return torch.relu(self.project(torch.cat(branches, 1))).permute(0, 2, 3, 1)
