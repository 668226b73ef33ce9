"""Deformable convolution v1 and v2 (modulated), in plain torch.

Counterpart of ``vnext_tpu.ops.deform_conv.deform_conv2d`` (reference surface:
detectron2/layers/deform_conv.py DeformConv / ModulatedDeformConv). Each
output location samples its kh x kw taps at learned offsets, bilinearly with
zeros outside the map (each corner by itself), v2 scales each tap by its
modulation, and the taps contract with the weights. The layouts are the JAX
package's: x [B, H, W, Cin], offsets [B, Ho, Wo, 2 * kh * kw] as (dy, dx) per
tap in the reference's order, the weight HWIO [kh, kw, Cin, Cout],
modulation [B, Ho, Wo, kh * kw]; the output is f32 [B, Ho, Wo, Cout].

Everything is computed in f32, as the JAX package's einsum computes it. Where
that one contracts tap by tap, this one gathers every tap's samples into one
[B * Ho * Wo, kh * kw * Cin] matrix (four gathers, one a bilinear corner)
and contracts it in one product: the same terms summed in another order. The
JAX package computes it outside any Pallas kernel (gathers and ``einsum``), so
the port has no hand-written kernel for it.
"""

from __future__ import annotations

from typing import Optional

import torch


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: int = 1, padding: int = 1, dilation: int = 1,
                  modulation: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Returns [B, Ho, Wo, Cout] in f32."""
    b, h, w, cin = x.shape
    kh, kw, _, cout = weight.shape
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    k = kh * kw
    dev = x.device
    off = offsets.float().reshape(b, ho, wo, k, 2)
    base_y = (torch.arange(ho, device=dev) * stride - padding).float()
    base_x = (torch.arange(wo, device=dev) * stride - padding).float()
    tap_y = (torch.arange(kh, device=dev) * dilation).repeat_interleave(kw).float()      # tap k = iy * kw + ix
    tap_x = (torch.arange(kw, device=dev) * dilation).repeat(kh).float()
    sy = base_y[None, :, None, None] + tap_y + off[..., 0]                               # [B, Ho, Wo, K]
    sx = base_x[None, None, :, None] + tap_x + off[..., 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    ty, tx = sy - y0, sx - x0
    flat = x.float().reshape(b * h * w, cin)
    base = (torch.arange(b, device=dev) * (h * w))[:, None, None, None]
    cols = 0.0
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi, xi = y0 + dy, x0 + dx
        wgt = (tx if dx else 1 - tx) * (ty if dy else 1 - ty)
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = base + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        g = flat[idx.reshape(-1)].reshape(b, ho, wo, k, cin)
        cols = cols + g * (wgt * valid)[..., None]
    if modulation is not None:
        cols = cols * modulation.float()[..., None]
    out = cols.reshape(b * ho * wo, k * cin) @ weight.float().reshape(k * cin, cout)
    out = out.reshape(b, ho, wo, cout)
    if bias is not None:
        out = out + bias
    return out
