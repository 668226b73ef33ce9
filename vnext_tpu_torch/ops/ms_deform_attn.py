"""Multi-scale deformable attention (MSDA) forward with the fused entry semantics.

Counterpart of ``vnext_tpu.ops.ms_deform_attn.ms_deform_attn_cm_fused`` with
``attn_is_logits=True``, token-major: the raw sampling offsets, the reference
points and the raw attention logits go in, and the locations and the softmax over
(L, P) are formed here. Per query q, head m:

    out[b, q, m] = sum_{l,p} softmax(logits[b, q, m])[l, p]
                   * bilinear(V_l[b, :, :, m], x[b, q, m, l, p], y[b, q, m, l, p])

with pixel coordinates (align_corners=False, zero padding outside the level)

    point reference [B, Q, L, 2]:  x = ref_x * w_l - 0.5 + off_x
    box reference   [B, Q, L, 4]:  x = (ref_x + off_x / P * ref_w * 0.5) * w_l - 0.5

(likewise for y with h_l). Offsets are in level pixels, as the projection emits
them. Sums and the softmax are f32; the output has the value's dtype.

Without autograd the call is the operator ``torch.ops.vnext.msda_fwd`` (so
that ``torch.export`` keeps it in a graph): on a CPU tensor it runs
:func:`ms_deform_attn_plain`; on a CUDA tensor the hand-written kernel
``csrc/ms_deform_attn_fwd.cu`` (K1) or it raises. The fused entry is
inference-only, as the TPU one is: it has no backward, and on the card it
raises when autograd would need one (on the CPU the plain version runs with
its autograd).

The standard entry (training), :func:`ms_deform_attn_standard` with
``impl="pallas_v9"``, is the counterpart of
``vnext_tpu.ops.ms_deform_attn_pallas_v9.ms_deform_attn_pallas_v9`` with its
custom VJP: normalized f32 locations [B, Q, M, L, P, 2] and softmaxed weights
[B, Q, M, L, P] go in, and

    out[b, q, m] = sum_{l,p} attn[b, q, m, l, p] * bilinear(V_l[b, :, :, m], x, y),
    x = loc_x * w_l - 0.5,  y = loc_y * h_l - 0.5.

Its forward is the operator ``torch.ops.vnext.msda_fwd_loc``: K4
(``vnext_msda_fwd_loc`` in the same source) on the card and
:func:`ms_deform_attn_core_plain`, ``ms_deform_attn_core_jnp`` in torch, on the
CPU. Under autograd a ``torch.autograd.Function`` wraps the operator; its
backward is K5 (``csrc/ms_deform_attn_bwd.cu``) on the card and autograd
through the plain core's gathers on the CPU.

Each operator's CUDA implementation checks what its kernel takes (dtypes,
contiguity, 16-byte alignment of the pointers) and counts the launch, so a
traced graph counts nothing and a loaded program counts every launch it makes.

The implementation selector :func:`ms_deform_attn_standard` is the counterpart
of ``vnext_tpu.ops.ms_deform_attn.ms_deform_attn(..., impl)``, the function
behind ``cfg.TPU.MSDA_IMPL``. The TPU's kernel generations v6 (``pallas``), v7
and v8 compute the standard entry's function in its layout under one rounding
contract (f32 sums, the output in the value's dtype, zero from a corner outside
its level); they differ only in how they schedule VMEM and the MXU. So on the
card each of them routes onto K4 forward and K5 backward, and counts its
launches on a counter of its own beside K4's and K5's. ``jnp`` and ``xla`` run
the plain version on any device, because the config asks for it. The TPU kernels
round the x-selector weights to the value dtype before the MXU product (v6 also
its row intermediate), and ``xla`` rounds its selector and its ``z`` slab to
bf16; every route of the port keeps the oracle's f32 weights, so in bf16 the
port and the TPU differ by those roundings, and in f32 they agree.

:func:`ms_deform_attn_cm` is the channel-major entry with precomputed locations
(``ms_deform_attn_pallas_v9_cm``): on the card its ``auto`` / ``pallas_v9``
route is K4b (``vnext_msda_fwd_loc_cm``), inference-only as the TPU entry.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch

from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import register_flop_formula

from .._build import Kernel, check, load_library, refuse_grad, stream_handle

KERNEL = Kernel(
    name="ms_deform_attn_fwd",
    source="vnext_tpu_torch/csrc/ms_deform_attn_fwd.cu",
    replaces="vnext_tpu/ops/ms_deform_attn_pallas_v9.py:67",
)
KERNEL_V9_FWD = Kernel(
    name="ms_deform_attn_v9_fwd",
    source="vnext_tpu_torch/csrc/ms_deform_attn_fwd.cu",
    replaces="vnext_tpu/ops/ms_deform_attn_pallas_v9.py:472",
)
KERNEL_V9_BWD = Kernel(
    name="ms_deform_attn_v9_bwd",
    source="vnext_tpu_torch/csrc/ms_deform_attn_bwd.cu",
    replaces="vnext_tpu/ops/ms_deform_attn_pallas_v9_bwd.py:55",
)
KERNEL_CM = Kernel(
    name="ms_deform_attn_v9_cm",
    source="vnext_tpu_torch/csrc/ms_deform_attn_fwd.cu",
    replaces="vnext_tpu/ops/ms_deform_attn_pallas_v9.py:652",
)
# the selector's routes onto K4 / K5: each counts beside K4's and K5's counters
KERNEL_V6_FWD = Kernel(
    name="ms_deform_attn_v6_fwd",
    source="vnext_tpu_torch/csrc/ms_deform_attn_fwd.cu",
    replaces="vnext_tpu/ops/ms_deform_attn_pallas.py:68",
)
KERNEL_V6_BWD = Kernel(
    name="ms_deform_attn_v6_bwd",
    source="vnext_tpu_torch/csrc/ms_deform_attn_bwd.cu",
    replaces="vnext_tpu/ops/ms_deform_attn_pallas.py:248",
)
KERNEL_V7_FWD = Kernel(
    name="ms_deform_attn_v7_fwd",
    source="vnext_tpu_torch/csrc/ms_deform_attn_fwd.cu",
    replaces="vnext_tpu/ops/attic/ms_deform_attn_pallas_v7.py:60",
)
KERNEL_V8_FWD = Kernel(
    name="ms_deform_attn_v8_fwd",
    source="vnext_tpu_torch/csrc/ms_deform_attn_fwd.cu",
    replaces="vnext_tpu/ops/attic/ms_deform_attn_pallas_v8.py:59",
)

# cfg.TPU.MSDA_IMPL -> the counters its forward and its backward launches add to
# (K4 / K5 and the route's own); jnp and xla run the plain version
_ROUTES = {
    "auto": ((KERNEL_V9_FWD,), (KERNEL_V9_BWD,)),
    "pallas_v9": ((KERNEL_V9_FWD,), (KERNEL_V9_BWD,)),
    "pallas": ((KERNEL_V9_FWD, KERNEL_V6_FWD), (KERNEL_V9_BWD, KERNEL_V6_BWD)),
    "pallas_v7": ((KERNEL_V9_FWD, KERNEL_V7_FWD), (KERNEL_V9_BWD, KERNEL_V6_BWD)),
    "pallas_v8": ((KERNEL_V9_FWD, KERNEL_V8_FWD), (KERNEL_V9_BWD, KERNEL_V6_BWD)),
    "jnp": None,
    "xla": None,
}
IMPLS = tuple(_ROUTES)
# the impls whose inference path is the fused entry (K1), as in the JAX package
FUSED_IMPLS = ("auto", "pallas_v9")


def check_impl(impl: str) -> str:
    """``impl`` if the JAX package knows it; else ValueError (the JAX dispatcher
    would quietly run its plain core, which on the card is a hidden plain path)."""
    if impl not in _ROUTES:
        raise ValueError(f"unknown MSDA impl {impl!r}: expected one of {IMPLS}")
    return impl

Shapes = Sequence[Tuple[int, int]]


def _check_args(value, spatial_shapes, offsets, reference_points, logits):
    b, s, m, d = value.shape
    if offsets.dim() != 6 or offsets.shape[0] != b or offsets.shape[2] != m or offsets.shape[-1] != 2:
        raise ValueError(f"offsets must be [B, Q, M, L, P, 2], got {tuple(offsets.shape)}")
    q, l, p = offsets.shape[1], offsets.shape[3], offsets.shape[4]
    if len(spatial_shapes) != l:
        raise ValueError(f"{len(spatial_shapes)} spatial shapes for {l} levels")
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"value has {s} tokens, the levels {tuple(spatial_shapes)} sum to another")
    if reference_points.shape[:3] != (b, q, l) or reference_points.shape[-1] not in (2, 4):
        raise ValueError(f"reference_points must be [B, Q, L, 2|4], got {tuple(reference_points.shape)}")
    if logits.shape != (b, q, m, l * p):
        raise ValueError(f"logits must be [B, Q, M, L*P], got {tuple(logits.shape)}")
    return b, s, m, d, q, l, p


def ms_deform_attn(
    value: torch.Tensor,             # [B, S, M, D], padding already zeroed
    spatial_shapes: Shapes,          # ((H_0, W_0), ...) python ints
    offsets: torch.Tensor,           # [B, Q, M, L, P, 2] raw, level pixels
    reference_points: torch.Tensor,  # [B, Q, L, 2] or [B, Q, L, 4] in [0, 1]
    logits: torch.Tensor,            # [B, Q, M, L*P] raw
) -> torch.Tensor:
    """Returns [B, Q, M*D] in value.dtype."""
    _check_args(value, spatial_shapes, offsets, reference_points, logits)
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ms_deform_attn: no implementation for device {value.device}")
    tensors = (value, offsets, reference_points, logits)
    if value.device.type == "cuda":
        refuse_grad("ms_deform_attn (the fused entry)", *tensors)
    elif torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return ms_deform_attn_plain(value, spatial_shapes, offsets, reference_points, logits)
    return msda_fwd_op(value, offsets, reference_points, logits, flat_shapes(spatial_shapes))


def flat_shapes(spatial_shapes: Shapes) -> List[int]:
    """((H_0, W_0), ...) -> [H_0, W_0, ...], the operators' form of the levels."""
    return [int(v) for hw in spatial_shapes for v in hw]


def _pairs(flat: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(h), int(w)) for h, w in zip(flat[::2], flat[1::2]))


@torch.library.custom_op("vnext::msda_fwd", mutates_args=(), device_types="cpu")
def msda_fwd_op(value: torch.Tensor, offsets: torch.Tensor, reference_points: torch.Tensor,
                logits: torch.Tensor, spatial_shapes: List[int]) -> torch.Tensor:
    """The fused entry as an operator (levels flattened, :func:`flat_shapes`):
    the plain version on the CPU, K1 on the card (registered below)."""
    return ms_deform_attn_plain(value, _pairs(spatial_shapes), offsets, reference_points, logits)


@msda_fwd_op.register_kernel("cuda")
def _msda_fwd_cuda(value, offsets, reference_points, logits, spatial_shapes):
    return _launch(value, _pairs(spatial_shapes), offsets, reference_points, logits)


@msda_fwd_op.register_fake
def _msda_fwd_fake(value, offsets, reference_points, logits, spatial_shapes):
    b, _, m, d, q, _, _ = _check_args(value, _pairs(spatial_shapes), offsets, reference_points, logits)
    return value.new_empty(b, q, m * d)


def msda_flops(value_shape, loc_shape) -> int:
    """An MSDA forward's arithmetic, 2 operations per multiply-add: each query
    and head takes 4 bilinear corners of each of its L * P samples, each corner
    weighted into D channels (B * Q * M * L * P * 4 * D multiply-adds); the
    locations, the softmax and the corner weights are not counted."""
    b, _, m, d = value_shape
    q, l, p = loc_shape[1], loc_shape[3], loc_shape[4]
    return 2 * b * q * m * l * p * 4 * d


@register_flop_formula(torch.ops.vnext.msda_fwd)
def _msda_fwd_flops(value_shape, offsets_shape, *args, **kwargs) -> int:
    return msda_flops(value_shape, offsets_shape)


def pixel_locations(spatial_shapes: Shapes, offsets, reference_points):
    """[B, Q, M, L, P, 2] f32 pixel coordinates (x, y) of every sample."""
    p = offsets.shape[4]
    off = offsets.float()
    ref = reference_points.float()[:, :, None, :, None, :]        # [B, Q, 1, L, 1, 2|4]
    wh = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                      device=off.device)[:, None, :]               # [L, 1, 2]
    if reference_points.shape[-1] == 2:
        return ref * wh - 0.5 + off
    return (ref[..., :2] + off / p * ref[..., 2:] * 0.5) * wh - 0.5


def ms_deform_attn_plain(value, spatial_shapes, offsets, reference_points, logits):
    """Plain PyTorch version: gathers the four corners of every sample."""
    b, s, m, d, q, l, p = _check_args(value, spatial_shapes, offsets, reference_points, logits)
    attn = torch.softmax(logits.float(), dim=-1).view(b, q, m, l, p)
    pix = pixel_locations(spatial_shapes, offsets, reference_points)
    return _bilinear_sum(value, spatial_shapes, pix, attn).to(value.dtype)


def _bilinear_sum(value, spatial_shapes, pix, attn):
    """sum_{l,p} attn * bilinear(V_l, pix) -> [B, Q, M*D] in the sums' dtype
    (f32, or f64 for f64 inputs). pix [B, Q, M, L, P, 2] are pixel coordinates
    (align_corners=False); a corner outside its level adds zero."""
    b, s, m, d = value.shape
    q, p = pix.shape[1], pix.shape[4]
    ct = torch.promote_types(value.dtype, torch.float32)
    v = value.to(ct).permute(0, 2, 1, 3)                           # [B, M, S, D]
    pix, attn = pix.to(ct), attn.to(ct)
    out = torch.zeros(b, m, q, d, dtype=ct, device=value.device)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v_l = v[:, :, start:start + h * w]
        start += h * w
        x = pix[:, :, :, lvl, :, 0].permute(0, 2, 1, 3)            # [B, M, Q, P]
        y = pix[:, :, :, lvl, :, 1].permute(0, 2, 1, 3)
        a = attn[:, :, :, lvl].permute(0, 2, 1, 3)
        x0, y0 = torch.floor(x), torch.floor(y)
        tx, ty = x - x0, y - y0
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            xi, yi = x0 + dx, y0 + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            wgt = (tx if dx else 1.0 - tx) * (ty if dy else 1.0 - ty) * valid * a
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
            g = torch.gather(v_l, 2, idx.reshape(b, m, q * p, 1).expand(-1, -1, -1, d))
            out = out + (wgt[..., None] * g.view(b, m, q, p, d)).sum(3)
    return out.permute(0, 2, 1, 3).reshape(b, q, m * d)


def _check_v9_args(value, spatial_shapes, loc, attn):
    b, s, m, d = value.shape
    if loc.dim() != 6 or loc.shape[0] != b or loc.shape[2] != m or loc.shape[-1] != 2:
        raise ValueError(f"sampling_locations must be [B, Q, M, L, P, 2], got {tuple(loc.shape)}")
    q, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    if len(spatial_shapes) != l:
        raise ValueError(f"{len(spatial_shapes)} spatial shapes for {l} levels")
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(f"value has {s} tokens, the levels {tuple(spatial_shapes)} sum to another")
    if attn.shape != loc.shape[:-1]:
        raise ValueError(f"attention_weights must be [B, Q, M, L, P], got {tuple(attn.shape)}")
    return b, s, m, d, q, l, p


def ms_deform_attn_standard(
    value: torch.Tensor,                # [B, S, M, D], padding already zeroed
    spatial_shapes: Shapes,             # ((H_0, W_0), ...) python ints
    sampling_locations: torch.Tensor,   # [B, Q, M, L, P, 2] normalized, f32
    attention_weights: torch.Tensor,    # [B, Q, M, L, P] softmaxed
    impl: str = "auto",
) -> torch.Tensor:
    """The standard entry under ``cfg.TPU.MSDA_IMPL``: returns [B, Q, M*D] in
    value.dtype with a gradient to all three tensors. Every kernel route runs K4
    forward and K5 backward on the card (and counts on its own counter beside
    theirs); ``jnp`` and ``xla`` run :func:`ms_deform_attn_core_plain` and its
    autograd on any device (``xla`` with f32 selector weights, where the JAX
    package rounds its selector and ``z`` to bf16). CPU tensors run the plain
    version on every route."""
    check_impl(impl)
    _check_v9_args(value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ms_deform_attn_standard: no implementation for device {value.device}")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if _ROUTES[impl] is None:
        return ms_deform_attn_core_plain(value, shapes, sampling_locations, attention_weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (value, sampling_locations, attention_weights)):
        return _MSDeformAttnV9.apply(value, shapes, sampling_locations, attention_weights, impl)
    return msda_fwd_loc_op(value, sampling_locations, attention_weights, flat_shapes(shapes), impl)


def _kernel_route(impl: str):
    """The forward and backward counters of a kernel route; ValueError for an
    unknown impl or one that runs the plain version (``jnp``, ``xla``)."""
    routes = _ROUTES[check_impl(impl)]
    if routes is None:
        raise ValueError(f"MSDA impl {impl!r} runs the plain version, not the operator")
    return routes


@torch.library.custom_op("vnext::msda_fwd_loc", mutates_args=(), device_types="cpu")
def msda_fwd_loc_op(value: torch.Tensor, sampling_locations: torch.Tensor, attention_weights: torch.Tensor,
                    spatial_shapes: List[int], impl: str) -> torch.Tensor:
    """The standard entry's forward as an operator (levels flattened,
    :func:`flat_shapes`; ``impl`` one of the kernel routes): the plain core on
    the CPU, K4 on the card (registered below), counted on the route of
    ``impl``."""
    _kernel_route(impl)
    return ms_deform_attn_core_plain(value, _pairs(spatial_shapes), sampling_locations, attention_weights)


@msda_fwd_loc_op.register_kernel("cuda")
def _msda_fwd_loc_cuda(value, sampling_locations, attention_weights, spatial_shapes, impl):
    return _launch_v9_fwd(value, _pairs(spatial_shapes), sampling_locations, attention_weights,
                          _kernel_route(impl)[0])


@msda_fwd_loc_op.register_fake
def _msda_fwd_loc_fake(value, sampling_locations, attention_weights, spatial_shapes, impl):
    _kernel_route(impl)
    b, _, m, d, q, _, _ = _check_v9_args(value, _pairs(spatial_shapes), sampling_locations, attention_weights)
    return value.new_empty(b, q, m * d)


@register_flop_formula(torch.ops.vnext.msda_fwd_loc)
def _msda_fwd_loc_flops(value_shape, loc_shape, *args, **kwargs) -> int:
    return msda_flops(value_shape, loc_shape)


class _MSDeformAttnV9(torch.autograd.Function):
    """Forward K4 (the operator) and backward K5 on the card, counted on the
    route of ``impl``; the plain core and its autograd on the CPU. The backward
    returns (dvalue in value's dtype, dloc in the locations' dtype, dattn in the
    weights' dtype), as ``_backward_v9`` does."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, loc, attn, impl):
        ctx.spatial_shapes, ctx.impl = spatial_shapes, impl
        ctx.save_for_backward(value, loc, attn)
        return msda_fwd_loc_op(value, loc, attn, flat_shapes(spatial_shapes), impl)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        value, loc, attn = ctx.saved_tensors
        dvalue, dloc, dattn = ms_deform_attn_v9_backward(value, ctx.spatial_shapes, loc, attn, grad,
                                                         ctx.impl)
        return dvalue, None, dloc, dattn, None


def ms_deform_attn_v9_backward(value, spatial_shapes, sampling_locations, attention_weights, grad,
                               impl: str = "pallas_v9"):
    """The standard entry's backward alone: (dvalue, dloc, dattn) under the
    cotangent ``grad`` [B, Q, M*D], each in its input's dtype. K5 on the card
    (counted on the route of ``impl``), :func:`ms_deform_attn_grad_plain` on the
    CPU."""
    if value.is_cuda:
        return _launch_v9_bwd(value, spatial_shapes, sampling_locations, attention_weights, grad,
                              _ROUTES[check_impl(impl)][1])
    return ms_deform_attn_grad_plain(value, spatial_shapes, sampling_locations, attention_weights, grad)


def ms_deform_attn_cm(
    valueT: torch.Tensor,           # [B, M*D, S], padding already zeroed
    spatial_shapes: Shapes,         # ((H_0, W_0), ...) python ints
    loc_cm: torch.Tensor,           # [B, M, L, P, 2, Q] normalized, f32
    attn_cm: torch.Tensor,          # [B, M, L, P, Q] softmaxed
    impl: str = "auto",
) -> torch.Tensor:
    """Channel-major entry with precomputed locations; returns [B, M*D, Q] in
    valueT.dtype. ``auto`` / ``pallas_v9`` run K4b on the card (inference-only,
    as ``ms_deform_attn_pallas_v9_cm``: it raises under autograd) and the plain
    core (as :func:`ms_deform_attn_cm_plain`) on the CPU; every other impl transposes to
    the standard layout and takes :func:`ms_deform_attn_standard`, as the JAX
    entry does."""
    check_impl(impl)
    value, loc, attn = _standard_layout(valueT, spatial_shapes, loc_cm, attn_cm)
    if impl not in FUSED_IMPLS:
        out = ms_deform_attn_standard(value, spatial_shapes, loc, attn, impl)
    elif valueT.device.type == "cpu":
        out = ms_deform_attn_core_plain(value, spatial_shapes, loc, attn)
    elif valueT.device.type != "cuda":
        raise ValueError(f"ms_deform_attn_cm: no implementation for device {valueT.device}")
    else:
        refuse_grad("ms_deform_attn_cm (the channel-major entry)", valueT, loc_cm, attn_cm)
        return _launch_cm(value, spatial_shapes, loc_cm, attn_cm)
    return out.transpose(1, 2).contiguous()


def _standard_layout(valueT, spatial_shapes, loc_cm, attn_cm):
    """valueT [B, M*D, S], loc_cm [B, M, L, P, 2, Q], attn_cm [B, M, L, P, Q] ->
    the standard entry's value [B, S, M, D], locations and weights (views)."""
    if valueT.dim() != 3 or loc_cm.dim() != 6 or attn_cm.dim() != 5:
        raise ValueError(f"ms_deform_attn_cm takes valueT [B, M*D, S], loc_cm [B, M, L, P, 2, Q] and "
                         f"attn_cm [B, M, L, P, Q], got {tuple(valueT.shape)}, {tuple(loc_cm.shape)}, "
                         f"{tuple(attn_cm.shape)}")
    b, md, s = valueT.shape
    m = loc_cm.shape[1]
    if md % m:
        raise ValueError(f"valueT has {md} channels for {m} heads")
    value = valueT.view(b, m, md // m, s).permute(0, 3, 1, 2)
    loc, attn = loc_cm.movedim(5, 1), attn_cm.movedim(4, 1)
    _check_v9_args(value, spatial_shapes, loc, attn)
    return value, loc, attn


def ms_deform_attn_cm_plain(valueT, spatial_shapes, loc_cm, attn_cm):
    """Plain PyTorch version of the channel-major entry: the plain core in the
    standard layout, transposed back to [B, M*D, Q]."""
    value, loc, attn = _standard_layout(valueT, spatial_shapes, loc_cm, attn_cm)
    return ms_deform_attn_core_plain(value, spatial_shapes, loc, attn).transpose(1, 2).contiguous()


def ms_deform_attn_core_plain(value, spatial_shapes, sampling_locations, attention_weights):
    """Plain PyTorch version of the standard entry (``ms_deform_attn_core_jnp``):
    gathers the four corners of every sample. Sums are f32 (f64 for f64 inputs);
    the output has the value's dtype."""
    _check_v9_args(value, spatial_shapes, sampling_locations, attention_weights)
    ct = torch.promote_types(value.dtype, torch.float32)
    wh = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=ct,
                      device=value.device)[:, None, :]              # [L, 1, 2]
    pix = sampling_locations.to(ct) * wh - 0.5                      # as grid_sample sees them
    return _bilinear_sum(value, spatial_shapes, pix, attention_weights).to(value.dtype)


def ms_deform_attn_grad_plain(value, spatial_shapes, sampling_locations, attention_weights, grad):
    """(dvalue, dloc, dattn) of :func:`ms_deform_attn_core_plain` under the
    cotangent ``grad``, by autograd; each in its input's dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True)
                  for t in (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_core_plain(leaves[0], spatial_shapes, leaves[1], leaves[2])
        return torch.autograd.grad(out, leaves, grad)


@functools.lru_cache(maxsize=64)
def _level_table(spatial_shapes: Tuple[Tuple[int, int], ...], device: torch.device):
    rows, start = [], 0
    for h, w in spatial_shapes:
        rows.append((h, w, start))
        start += h * w
    return torch.tensor(rows, dtype=torch.int32, device=device)


def _launch(value, spatial_shapes, offsets, reference_points, logits):
    b, s, m, d = value.shape
    q, l, p = offsets.shape[1], offsets.shape[3], offsets.shape[4]
    _check_kernel_args(value, p, l, (("value", value, torch.bfloat16),
                                     ("offsets", offsets, torch.bfloat16),
                                     ("logits", logits, torch.bfloat16),
                                     ("reference_points", reference_points, torch.float32)))
    if b > 65535:
        raise ValueError(f"the fused MSDA kernel puts the batch on grid y (<= 65535), got {b}")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    levels = _level_table(shapes, value.device)
    out = torch.empty(b, q, m * d, dtype=value.dtype, device=value.device)
    _check_aligned(("value", value), ("offsets", offsets), ("logits", logits), ("out", out))
    lib = load_library().lib
    with torch.cuda.device(value.device):
        code = lib.vnext_msda_fwd(
            value.data_ptr(), offsets.data_ptr(), reference_points.data_ptr(),
            logits.data_ptr(), levels.data_ptr(), out.data_ptr(),
            b, q, s, m, l, p, reference_points.shape[-1], stream_handle(value.device),
        )
    check(code, "ms_deform_attn_fwd")
    KERNEL.launches += 1
    return out


def _check_kernel_args(value, p, l, named):
    """What the MSDA kernels take: D == 32, L*P <= 16, contiguous tensors of
    the given dtypes on value's device."""
    d = value.shape[-1]
    if d != 32:
        raise ValueError(f"the MSDA kernels give a head's channels to 4 lanes of 8: need D == 32, got {d}")
    if l * p > 16 or l > 8:
        raise ValueError(f"the MSDA kernels give a head's samples to 4 lanes of 4: need L*P <= 16 and "
                         f"L <= 8, got {l}*{p}")
    for name, t, dt in named:
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if t.dtype != dt:
            raise TypeError(f"the MSDA kernel takes {name} as {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the MSDA kernel needs {name} contiguous")


def _check_aligned(*named, what="the fused MSDA kernel"):
    """K1, K4, K4b and K5 read and write 16-byte vectors: each such tensor must
    start on a 16-byte boundary."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{what} reads {name} in 16-byte vectors: it must be "
                             f"16-byte aligned, got a view at offset {t.data_ptr() % 16}")


def _launch_v9_fwd(value, spatial_shapes, loc, attn, counters=(KERNEL_V9_FWD,)):
    b, s, m, d = value.shape
    q, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    _check_kernel_args(value, p, l, (("value", value, torch.bfloat16),
                                     ("sampling_locations", loc, torch.float32),
                                     ("attention_weights", attn, torch.bfloat16)))
    if b > 65535:
        raise ValueError(f"the MSDA standard-entry kernel puts the batch on grid y (<= 65535), got {b}")
    levels = _level_table(spatial_shapes, value.device)
    out = torch.empty(b, q, m * d, dtype=value.dtype, device=value.device)
    _check_aligned(("value", value), ("sampling_locations", loc), ("attention_weights", attn), ("out", out),
                   what="the MSDA standard-entry kernel")
    lib = load_library().lib
    with torch.cuda.device(value.device):
        code = lib.vnext_msda_fwd_loc(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(), levels.data_ptr(),
            out.data_ptr(), b, q, s, m, l, p, stream_handle(value.device),
        )
    check(code, "ms_deform_attn_v9_fwd")
    for kern in counters:
        kern.launches += 1
    return out


def _launch_cm(value, spatial_shapes, loc_cm, attn_cm):
    """value: the token-major view [B, S, M, D] of valueT (``_standard_layout``)."""
    # one transpose to token-major memory: K4's loop reads each corner of a
    # head as 16-byte pieces of its 64-byte row, which the channel-major layout
    # (a head's channels S apart) cannot give
    value = value.contiguous()
    b, s, m, d = value.shape
    l, p, q = loc_cm.shape[2], loc_cm.shape[3], loc_cm.shape[5]
    _check_kernel_args(value, p, l, (("value", value, torch.bfloat16),
                                     ("loc_cm", loc_cm, torch.float32),
                                     ("attn_cm", attn_cm, torch.bfloat16)))
    if b > 65535:
        raise ValueError(f"the channel-major MSDA kernel puts the batch on grid y (<= 65535), got {b}")
    # the locations and weights are read one query per lane and the output
    # written so, in runs along Q: only the value is read in 16-byte vectors
    _check_aligned(("value", value), what="the channel-major MSDA kernel")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    levels = _level_table(shapes, value.device)
    out = torch.empty(b, m * d, q, dtype=value.dtype, device=value.device)
    lib = load_library().lib
    with torch.cuda.device(value.device):
        code = lib.vnext_msda_fwd_loc_cm(
            value.data_ptr(), loc_cm.data_ptr(), attn_cm.data_ptr(), levels.data_ptr(),
            out.data_ptr(), b, q, s, m, l, p, stream_handle(value.device),
        )
    check(code, "ms_deform_attn_v9_cm")
    KERNEL_CM.launches += 1
    return out


def _launch_v9_bwd(value, spatial_shapes, loc, attn, grad, counters=(KERNEL_V9_BWD,)):
    b, s, m, d = value.shape
    q, l, p = loc.shape[1], loc.shape[3], loc.shape[4]
    grad = grad.contiguous()
    _check_kernel_args(value, p, l, (("value", value, torch.bfloat16),
                                     ("sampling_locations", loc, torch.float32),
                                     ("attention_weights", attn, torch.bfloat16),
                                     ("the cotangent", grad, torch.bfloat16)))
    if grad.shape != (b, q, m * d):
        raise ValueError(f"the cotangent must be [B, Q, M*D], got {tuple(grad.shape)}")
    if b > 65535:
        raise ValueError(f"the MSDA backward kernel puts the batch on grid y (<= 65535), got {b}")
    _check_aligned(("value", value), ("sampling_locations", loc), ("attention_weights", attn),
                   ("the cotangent", grad), what="the MSDA backward kernel")
    levels = _level_table(spatial_shapes, value.device)
    scratch = torch.zeros(b, s, m, d, dtype=torch.float32, device=value.device)
    dvalue = torch.empty_like(value)
    dloc = torch.empty_like(loc)
    dattn = torch.empty_like(attn)
    lib = load_library().lib
    with torch.cuda.device(value.device):
        code = lib.vnext_msda_bwd(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(), grad.data_ptr(),
            levels.data_ptr(), scratch.data_ptr(), dloc.data_ptr(), dattn.data_ptr(),
            dvalue.data_ptr(), b, q, s, m, l, p, stream_handle(value.device),
        )
    check(code, "ms_deform_attn_v9_bwd")
    for kern in counters:
        kern.launches += 1
    return dvalue, dloc, dattn
