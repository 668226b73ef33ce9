"""Separable image resizing with the JAX package's exact interpolation matrices.

Counterpart of ``vnext_tpu.ops.interpolate``. Each resize is two small dense
products against an [out, in] matrix built once on the host, which reproduces
the JAX package's results to f32 rounding:

- ``resize_bilinear``: torch ``align_corners=False`` (half-pixel centres, edge clamp);
- ``resize_bilinear_ac``: torch ``align_corners=True`` (the corners' centres kept);
- ``resize_nearest``: torch 'nearest', source index ``floor(i * in / out)``;
- ``aligned_bilinear``: the CondInst upsampler (replicate pad + a 2-tap lerp);
- ``compute_locations``: pixel-centre (x, y) of a stride-``s`` grid.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _bilinear_matrix(in_size: int, out_size: int, align_corners: bool = False) -> np.ndarray:
    """[out, in] row-stochastic matrix."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = i * (in_size - 1) / max(out_size - 1, 1)
    else:
        src = (i + 0.5) * in_size / out_size - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = src - lo
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    np.add.at(mat, (rows, lo), (1.0 - w_hi).astype(np.float32))
    np.add.at(mat, (rows, hi), w_hi.astype(np.float32))
    return mat


@functools.lru_cache(maxsize=256)
def _nearest_matrix(in_size: int, out_size: int) -> np.ndarray:
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    i = np.arange(out_size, dtype=np.float64)
    src = np.minimum((i * in_size / out_size).astype(np.int64), in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    mat[np.arange(out_size), src] = 1.0
    return mat


@functools.lru_cache(maxsize=64)
def _aligned_upsample_matrix(in_size: int, factor: int) -> np.ndarray:
    """[factor*in, in] matrix realizing aligned_bilinear along one axis: pad one
    (replicate) at the end, upsample align_corners=True to f*n+1, pad f//2 at the
    front (replicate), keep the first f*n samples; each output is a 2-tap lerp."""
    n, f = in_size, factor
    mat = np.zeros((f * n, n + 1), dtype=np.float32)
    for i in range(f * n):
        q, r = divmod(max(i - f // 2, 0), f)
        w = r / f
        mat[i, q] += 1.0 - w
        if w > 0:
            mat[i, min(q + 1, n)] += w
    folded = mat[:, :n].copy()
    folded[:, n - 1] += mat[:, n]   # the replicate pad duplicates the last row
    return folded


def _apply_separable(x: torch.Tensor, mat_h: np.ndarray, mat_w: np.ndarray) -> torch.Tensor:
    """Resize the last two axes of x ([..., H, W])."""
    mh = torch.from_numpy(mat_h).to(device=x.device, dtype=x.dtype)
    mw = torch.from_numpy(mat_w).to(device=x.device, dtype=x.dtype)
    x = torch.einsum("oh,...hw->...ow", mh, x)
    return torch.einsum("pw,...ow->...op", mw, x)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return _apply_separable(x, _bilinear_matrix(x.shape[-2], out_h), _bilinear_matrix(x.shape[-1], out_w))


def resize_bilinear_ac(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return _apply_separable(x, _bilinear_matrix(x.shape[-2], out_h, True), _bilinear_matrix(x.shape[-1], out_w, True))


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return _apply_separable(x, _nearest_matrix(x.shape[-2], out_h), _nearest_matrix(x.shape[-1], out_w))


def aligned_bilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """CondInst-aligned upsampling of [..., H, W] by an integer factor."""
    if factor < 1 or int(factor) != factor:
        raise ValueError(f"aligned_bilinear needs an integer factor >= 1, got {factor}")
    if factor == 1:
        return x
    return _apply_separable(
        x, _aligned_upsample_matrix(x.shape[-2], factor), _aligned_upsample_matrix(x.shape[-1], factor)
    )


def compute_locations(h: int, w: int, stride: int = 1, device=None) -> torch.Tensor:
    """[H*W, 2] pixel-centre (x, y) locations of a stride-``stride`` grid."""
    ys = torch.arange(0, h * stride, stride, dtype=torch.float32, device=device)
    xs = torch.arange(0, w * stride, stride, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1) + stride // 2
