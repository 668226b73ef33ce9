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

A CPU tensor runs :func:`ms_deform_attn_plain`; a CUDA tensor runs the
hand-written kernel ``csrc/ms_deform_attn_fwd.cu`` or raises.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch

from .._build import Kernel, check, load_library, stream_handle

KERNEL = Kernel(
    name="ms_deform_attn_fwd",
    source="vnext_tpu_torch/csrc/ms_deform_attn_fwd.cu",
    replaces="vnext_tpu/ops/ms_deform_attn_pallas_v9.py:67",
)

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
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes, offsets, reference_points, logits)
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn: no implementation for device {value.device}")
    return _launch(value, spatial_shapes, offsets, reference_points, logits)


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
    v = value.float().permute(0, 2, 1, 3)                          # [B, M, S, D]
    out = torch.zeros(b, m, q, d, dtype=torch.float32, device=value.device)
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
            out += (wgt[..., None] * g.view(b, m, q, p, d)).sum(3)
    return out.permute(0, 2, 1, 3).reshape(b, q, m * d).to(value.dtype)


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
    if d != 32:
        raise ValueError(f"the MSDA kernel runs one lane per channel and needs D == 32, got {d}")
    if l * p > 16 or l > 8:
        raise ValueError(f"the MSDA kernel holds 2*L*P offsets in one warp: needs L*P <= 16, got {l}*{p}")
    for name, t, dt in (("value", value, torch.bfloat16), ("offsets", offsets, torch.bfloat16),
                        ("logits", logits, torch.bfloat16),
                        ("reference_points", reference_points, torch.float32)):
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on {value.device}")
        if t.dtype != dt:
            raise TypeError(f"the MSDA kernel takes {name} as {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the MSDA kernel needs {name} contiguous")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    levels = _level_table(shapes, value.device)
    out = torch.empty(b, q, m * d, dtype=value.dtype, device=value.device)
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
