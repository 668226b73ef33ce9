"""Swin Transformer backbone (the detection Swin of IDOL / SeqFormer / MinVIS).

Counterpart of ``vnext_tpu.models.backbones.swin.SwinTransformer``, with its
numerics:

- q·kᵀ in the compute dtype; the relative-position bias, the shift mask (-100)
  and the softmax in f32, cast back to the compute dtype before the product
  with v;
- exact GELU; LayerNorm eps 1e-6 (flax's; the reference Swin uses 1e-5);
- every block pads its map to a multiple of the window and keeps
  ``shift = window // 2`` however small the map (no clamping), as the
  reference's detection Swin does; ``PatchMerging`` pads odd sides.

The input is NHWC, as the port's ResNet's; the blocks work on NHWC token maps
and the outputs ``res2``..``res5`` are NCHW views of them (``channels_last``
memory, no copy). Module and parameter names follow the flax tree
(``patch_embed``, ``patch_norm``, ``layers_{s}_blocks_{b}.attn.qkv``,
``relative_position_bias_table`` [(2w-1)², heads], ``mlp_fc1``,
``downsample_{s}.reduction``, ``out_norm{s}``), so ``checkpoint/from_jax.py``
bridges it with no rule of its own.

The JAX package computes the window attention in XLA, outside any Pallas
kernel; here it is plain ``torch.matmul`` and ``softmax``.

Drop-path in train mode, as JAX's ``SwinBlock._drop_path``: block i of all the
blocks in order has the rate ``np.linspace(0, drop_path_rate, sum(depths))[i]``
(so the first block draws nothing); its attention branch before the first
residual add and its MLP branch before the second become
``x * keep_mask.to(x.dtype) / keep``, in x's dtype and in that order, with one
keep draw per sample ([B, 1, 1, 1]; B counts frames). The draws come from the
``generator`` the forward is given (the train step's), so a resumed run draws
what a straight run draws at the same step; they cannot equal JAX's bits.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv, Dense, LayerNorm


def _relative_position_index(window_size: int) -> np.ndarray:
    """[w*w, w*w] index into the (2w-1)^2 bias table (standard Swin indexing)."""
    w = window_size
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def _shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """[num_windows, ww, ww] additive mask (0 / -100) for shifted windows."""
    img_mask = np.zeros((hp, wp), np.int32)
    cnt = 0
    for h_sl in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for w_sl in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[h_sl, w_sl] = cnt
            cnt += 1
    m = img_mask.reshape(hp // window, window, wp // window, window)
    m = m.transpose(0, 2, 1, 3).reshape(-1, window * window)
    return np.where(m[:, None, :] != m[:, :, None], -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        self.qkv = Dense(dim, 3 * dim, dtype, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            _relative_position_index(window_size).reshape(-1)), persistent=False)
        self.proj = Dense(dim, dim, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.trunc_normal_(self.relative_position_bias_table, 0.0, 0.02, -0.04, 0.04, generator=gen)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x [nW*B, ww, C]; mask [nW, ww, ww] f32 or None."""
        b_, n, c = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(b_, n, 3, h, c // h).permute(2, 0, 3, 1, 4)       # [3, b_, h, n, hd]
        q, k, v = qkv[0], qkv[1], qkv[2]
        bias = self.relative_position_bias_table.float()[self.relative_position_index]
        # the compute-dtype logits [b_, h, n, n] plus the f32 bias: one f32 result, each
        # logit widened exactly before its addition, as JAX's cast-then-add
        attn = torch.add(torch.matmul(q * self.scale, k.transpose(-2, -1)), bias.view(n, n, h).permute(2, 0, 1))
        if mask is not None:
            nw = mask.shape[0]
            attn.view(b_ // nw, nw, h, n, n).add_(mask[None, :, None])
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(out)


def drop_path_mask(n: int, keep: float, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """[n, 1, 1, 1] bool: which of n samples keep the branch, each with
    probability ``keep``."""
    return torch.rand((n, 1, 1, 1), generator=generator, device=device) < keep


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_path: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.window_size, self.shift_size, self.dtype = window_size, shift_size, dtype
        self.drop_path = drop_path
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias, qk_scale, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        hidden = int(dim * mlp_ratio)
        self.mlp_fc1 = Dense(dim, hidden, dtype)
        self.mlp_fc2 = Dense(hidden, dim, dtype)
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _mask(self, hp: int, wp: int, device) -> torch.Tensor:
        key = (hp, wp, device)
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                _shift_attn_mask(hp, wp, self.window_size, self.shift_size)).to(device)
        return self._masks[key]

    def _drop_path(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.drop_path == 0.0:
            return x
        keep = 1.0 - self.drop_path
        mask = drop_path_mask(x.shape[0], keep, generator, x.device).to(x.dtype)
        # JAX divides by the rate rounded to x's dtype (a weakly typed Python float)
        return x * mask / torch.tensor(keep, dtype=x.dtype).item()

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, H, W, C] in the compute dtype; ``generator`` draws drop-path's
        masks in train mode."""
        b, h0, w0, c = x.shape
        win, shift = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x)
        pad_b, pad_r = (win - h0 % win) % win, (win - w0 % win) % win
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h0 + pad_b, w0 + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = self._mask(hp, wp, x.device)
        x = x.view(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)
        x = self.attn(x, mask)
        x = x.view(b, hp // win, wp // win, win, win, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + self._drop_path(x[:, :h0, :w0], generator)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + self._drop_path(y, generator)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(4 * dim, dtype)
        self.reduction = Dense(4 * dim, 2 * dim, dtype, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """Hierarchical Swin backbone; returns the ``out_features`` of res2..res5, NCHW."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7, patch_size: int = 4,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_path_rate: float = 0.2, patch_norm: bool = True,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embed_dim, self.depths = embed_dim, tuple(depths)
        self.patch_size, self.drop_path_rate = patch_size, drop_path_rate
        self.out_features = tuple(out_features)
        rates = np.linspace(0, drop_path_rate, sum(self.depths)).tolist()
        self.patch_embed = Conv(3, embed_dim, patch_size, patch_size, dtype=dtype)
        self.patch_norm = LayerNorm(embed_dim, dtype) if patch_norm else None
        for stage, depth in enumerate(self.depths):
            dim = embed_dim * 2 ** stage
            for d in range(depth):
                self.add_module(f"layers_{stage}_blocks_{d}", SwinBlock(
                    dim, num_heads[stage], window_size, 0 if d % 2 == 0 else window_size // 2,
                    mlp_ratio, qkv_bias, qk_scale, rates.pop(0), dtype))
            if f"res{stage + 2}" in self.out_features:
                self.add_module(f"out_norm{stage}", LayerNorm(dim, dtype))
            if stage < len(self.depths) - 1:
                self.add_module(f"downsample_{stage}", PatchMerging(dim, dtype))

    @property
    def output_channels(self) -> Dict[str, int]:
        return {f"res{i + 2}": self.embed_dim * 2 ** i for i in range(len(self.depths))}

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """x [B, H, W, 3] normalized -> {res2..res5 of ``out_features``} NCHW.
        In train mode drop-path draws from ``generator``."""
        p = self.patch_size
        h, w = x.shape[1], x.shape[2]
        x = F.pad(x, (0, 0, 0, (p - w % p) % p, 0, (p - h % p) % p))
        x = self.patch_embed(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.patch_norm is not None:
            x = self.patch_norm(x)
        outputs = {}
        for stage, depth in enumerate(self.depths):
            for d in range(depth):
                x = getattr(self, f"layers_{stage}_blocks_{d}")(x, generator)
            name = f"res{stage + 2}"
            if name in self.out_features:
                outputs[name] = getattr(self, f"out_norm{stage}")(x).permute(0, 3, 1, 2)
            if stage < len(self.depths) - 1:
                x = getattr(self, f"downsample_{stage}")(x)
        return outputs


def build_swin_backbone(cfg, dtype=torch.float32) -> SwinTransformer:
    """The Swin backbone of ``MODEL.SWIN`` (EMBED_DIM, DEPTHS, NUM_HEADS,
    WINDOW_SIZE, PATCH_SIZE, MLP_RATIO, QKV_BIAS, QK_SCALE, DROP_PATH_RATE,
    PATCH_NORM), with res2..res5 out, as the JAX package's function reads them.
    Its parameters are uninitialized (``models.layers.init_weights`` fills them)."""
    s = cfg.MODEL.SWIN
    return SwinTransformer(embed_dim=s.EMBED_DIM, depths=tuple(s.DEPTHS), num_heads=tuple(s.NUM_HEADS),
                           window_size=s.WINDOW_SIZE, patch_size=s.PATCH_SIZE, mlp_ratio=s.MLP_RATIO,
                           qkv_bias=s.QKV_BIAS, qk_scale=s.QK_SCALE, drop_path_rate=s.DROP_PATH_RATE,
                           patch_norm=s.PATCH_NORM, dtype=dtype)
