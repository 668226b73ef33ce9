"""Deformable transformer: the IDOL detection trunk, token-major.

Counterpart of ``vnext_tpu.models.deformable_transformer``. Spatial shapes are
python tuples; padding is a bottom/right rectangle per image, given as the valid
(h, w) of each level. The MSDA core is ``ops/ms_deform_attn.py`` (the
hand-written kernel on the card) and the encoder layer's tail is
``ops/encoder_epilogue.py`` (likewise). Every LayerNorm is eps 1e-6 with f32
statistics. Only the token-major form is ported: the JAX package's channel-major
twins are TPU relayout workarounds.

A module in eval mode runs the fused inference kernels. In train mode (the JAX
package's ``train=True``) the MSDA core takes the standard entry, which has a
backward, with the locations and the softmax formed in f32 as the JAX module's
token-major path forms them; the encoder layer's tail runs unfused; dropout
applies where the JAX layers apply it, drawing from the ``generator`` the
caller passes; and the decoder detaches the reference points after each layer.
The transformer holds the dropout rate (IDOL passes the configured one) and
hands it to its layers with each call.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.encoder_epilogue import encoder_epilogue
from ..ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_v9
from .layers import MLP, Dense, LayerNorm, MultiHeadAttention, dropout, inverse_sigmoid

Shapes = Sequence[Tuple[int, int]]


def offset_bias_grid(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """Head-direction grid bias of the sampling offsets, [M*L*P*2]."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformAttnModule(nn.Module):
    """Multi-scale deformable attention layer: projections + the MSDA core."""

    def __init__(self, d_model=256, n_levels=4, n_heads=8, n_points=4, dtype=torch.float32):
        super().__init__()
        self.m, self.l, self.p = n_heads, n_levels, n_points
        grid = torch.from_numpy(offset_bias_grid(n_heads, n_levels, n_points))
        self.value_proj = Dense(d_model, d_model, dtype)
        self.sampling_offsets = Dense(
            d_model, n_heads * n_levels * n_points * 2, dtype, kernel_init="zeros",
            bias_init=lambda b: b.copy_(grid),
        )
        self.attention_weights = Dense(d_model, n_heads * n_levels * n_points, dtype,
                                       kernel_init="zeros")
        self.output_proj = Dense(d_model, d_model, dtype)

    def forward(self, query, reference_points, src, spatial_shapes: Shapes, padding_mask=None):
        """query [B, Q, C]; reference_points [B, Q, L, 2|4] in [0, 1]; src [B, S, C];
        padding_mask [B, S] True on padding. Returns [B, Q, C]."""
        b, q, _ = query.shape
        m, l, p = self.m, self.l, self.p
        value = self.value_proj(src)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        value = value.view(b, src.shape[1], m, -1)
        offsets = self.sampling_offsets(query).view(b, q, m, l, p, 2)
        logits = self.attention_weights(query).view(b, q, m, l * p)
        if not self.training:
            out = ms_deform_attn(value, spatial_shapes, offsets,
                                 reference_points.float().contiguous(), logits)
            return self.output_proj(out)
        attn = torch.softmax(logits.float(), -1).to(logits.dtype).view(b, q, m, l, p)
        off = offsets.float()
        ref = reference_points.float()[:, :, None, :, None, :]           # [B, Q, 1, L, 1, 2|4]
        if ref.shape[-1] == 2:
            wh = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                              device=off.device)[:, None, :]              # [L, 1, 2]
            loc = ref + off / wh
        else:
            loc = ref[..., :2] + off / p * ref[..., 2:] * 0.5
        return self.output_proj(ms_deform_attn_v9(value, spatial_shapes, loc, attn))


class EncoderLayer(nn.Module):
    def __init__(self, d_model=256, d_ffn=1024, n_levels=4, n_heads=8, n_points=4,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MSDeformAttnModule(d_model, n_levels, n_heads, n_points, dtype)
        self.norm1 = LayerNorm(d_model, dtype)
        self.linear1 = Dense(d_model, d_ffn, dtype)
        self.linear2 = Dense(d_ffn, d_model, dtype)
        self.norm2 = LayerNorm(d_model, dtype)

    def forward(self, src, pos, reference_points, spatial_shapes: Shapes, padding_mask,
                rate: float = 0.0, generator=None):
        attn_out = self.self_attn(src + pos, reference_points, src, spatial_shapes, padding_mask)
        if not self.training:
            # LN1(src + attn) -> FFN -> LN2 in one pass (the epilogue kernel on the card)
            return encoder_epilogue(
                attn_out.to(self.dtype), src.to(self.dtype),
                self.norm1.weight, self.norm1.bias, self.linear1.weight, self.linear1.bias,
                self.linear2.weight, self.linear2.bias, self.norm2.weight, self.norm2.bias,
            )
        src = self.norm1(src + dropout(attn_out, rate, generator))
        ff = dropout(torch.relu(self.linear1(src)), rate, generator)
        return self.norm2(src + dropout(self.linear2(ff), rate, generator))


class DecoderLayer(nn.Module):
    def __init__(self, d_model=256, d_ffn=1024, n_levels=4, n_heads=8, n_points=4,
                 dtype=torch.float32):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.cross_attn = MSDeformAttnModule(d_model, n_levels, n_heads, n_points, dtype)
        self.norm1 = LayerNorm(d_model, dtype)
        self.linear1 = Dense(d_model, d_ffn, dtype)
        self.linear2 = Dense(d_ffn, d_model, dtype)
        self.norm3 = LayerNorm(d_model, dtype)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes: Shapes, padding_mask,
                rate: float = 0.0, generator=None):
        def drop(x):
            return dropout(x, rate, generator)

        q = tgt + query_pos
        tgt = self.norm2(tgt + drop(self.self_attn(q, q, tgt)))
        ca = self.cross_attn(tgt + query_pos, reference_points, src, spatial_shapes, padding_mask)
        tgt = self.norm1(tgt + drop(ca))
        ff = drop(self.linear2(drop(torch.relu(self.linear1(tgt)))))
        return self.norm3(tgt + ff)


def encoder_reference_points(spatial_shapes: Shapes, valid_ratios: torch.Tensor) -> torch.Tensor:
    """[B, S, L, 2] per-level grid reference points, normalized by the valid extent."""
    dev = valid_ratios.device
    refs = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None].expand(h, w).reshape(-1)
        rx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :].expand(h, w).reshape(-1)
        ry = ry[None] / (valid_ratios[:, None, lvl, 1] * h)
        rx = rx[None] / (valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([rx, ry], -1))
    ref = torch.cat(refs, 1)
    return ref[:, :, None] * valid_ratios[:, None]


class DeformableTransformer(nn.Module):
    """Encoder + box-refining decoder over flattened multi-level features."""

    def __init__(self, d_model=256, n_heads=8, num_encoder_layers=6, num_decoder_layers=6,
                 d_ffn=1024, num_feature_levels=4, enc_n_points=4, dec_n_points=4,
                 dtype=torch.float32, *, dropout: float):
        super().__init__()
        self.d_model, self.dtype = d_model, dtype
        self.dropout_rate = dropout
        self.num_encoder_layers, self.num_decoder_layers = num_encoder_layers, num_decoder_layers
        self.level_embed = nn.Parameter(torch.empty(num_feature_levels, d_model))
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_{i}", EncoderLayer(
                d_model, d_ffn, num_feature_levels, n_heads, enc_n_points, dtype))
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_{i}", DecoderLayer(
                d_model, d_ffn, num_feature_levels, n_heads, dec_n_points, dtype))
        self.reference_points = Dense(d_model, 2, dtype, kernel_init="xavier")
        for i in range(num_decoder_layers):
            # layer 0's final bias starts the boxes small: [2:] = -2
            bias_init = (lambda b: b.copy_(torch.tensor([0.0, 0.0, -2.0, -2.0]))) if i == 0 else None
            self.add_module(f"bbox_embed_{i}", MLP(
                d_model, d_model, 4, 3, dtype, final_kernel_init="zeros", final_bias_init=bias_init))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.level_embed, 0.0, 1.0, generator=gen)

    def forward(self, srcs: List[torch.Tensor], valid_hw: List[torch.Tensor],
                pos_embeds: List[torch.Tensor], query_embed: torch.Tensor, generator=None):
        """srcs / pos_embeds: L x [B, H_l, W_l, C]; valid_hw: L x [B, 2];
        query_embed [Q, 2C]. Returns (hs, memory, init_ref, inter_refs, out_coords):
        ``inter_refs`` are detached after each layer, ``out_coords`` (the boxes) not."""
        memory, spatial_shapes, mask_flat, valid_ratios = self.encode(
            srcs, valid_hw, pos_embeds, generator)
        return self.decode(memory, spatial_shapes, mask_flat, valid_ratios, query_embed, generator)

    def encode(self, srcs, valid_hw, pos_embeds, generator=None):
        b, c = srcs[0].shape[0], self.d_model
        spatial_shapes = tuple((int(s.shape[1]), int(s.shape[2])) for s in srcs)
        src_flat, pos_flat, mask_flat, vr = [], [], [], []
        for lvl, (src, pos) in enumerate(zip(srcs, pos_embeds)):
            h, w = spatial_shapes[lvl]
            src_flat.append(src.reshape(b, h * w, c))
            pos_flat.append(pos.reshape(b, h * w, c) + self.level_embed[lvl].to(pos.dtype))
            ys = torch.arange(h, device=src.device)[None, :, None]
            xs = torch.arange(w, device=src.device)[None, None, :]
            vh = valid_hw[lvl][:, 0][:, None, None]
            vw = valid_hw[lvl][:, 1][:, None, None]
            mask_flat.append(~((ys < vh) & (xs < vw)).reshape(b, h * w))
            vr.append(torch.stack([valid_hw[lvl][:, 1].float() / w, valid_hw[lvl][:, 0].float() / h], -1))
        memory = torch.cat(src_flat, 1)
        pos_flat = torch.cat(pos_flat, 1)
        mask_flat = torch.cat(mask_flat, 1)
        valid_ratios = torch.stack(vr, 1)                     # [B, L, 2] (w, h)

        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        rate = self.dropout_rate if self.training else 0.0
        for i in range(self.num_encoder_layers):
            memory = getattr(self, f"encoder_{i}")(
                memory, pos_flat, enc_ref, spatial_shapes, mask_flat, rate, generator)
        return memory, spatial_shapes, mask_flat, valid_ratios

    def decode(self, memory, spatial_shapes, mask_flat, valid_ratios, query_embed, generator=None):
        b = memory.shape[0]
        query_pos, tgt = torch.split(query_embed, query_embed.shape[1] // 2, dim=1)
        query_pos = query_pos[None].expand(b, -1, -1).to(self.dtype)
        output = tgt[None].expand(b, -1, -1).to(self.dtype)
        reference_points = torch.sigmoid(self.reference_points(query_pos).float())
        init_reference = reference_points
        rate = self.dropout_rate if self.training else 0.0

        hs, refs, coords = [], [], []
        for lid in range(self.num_decoder_layers):
            if reference_points.shape[-1] == 4:
                ref_input = reference_points[:, :, None] * torch.cat([valid_ratios, valid_ratios], -1)[:, None]
            else:
                ref_input = reference_points[:, :, None] * valid_ratios[:, None]
            output = getattr(self, f"decoder_{lid}")(
                output, query_pos, ref_input, memory, spatial_shapes, mask_flat, rate, generator)
            tmp = getattr(self, f"bbox_embed_{lid}")(output).float()
            if reference_points.shape[-1] == 4:
                new_ref = torch.sigmoid(tmp + inverse_sigmoid(reference_points))
            else:
                new_ref = torch.sigmoid(torch.cat(
                    [tmp[..., :2] + inverse_sigmoid(reference_points), tmp[..., 2:]], -1))
            coords.append(new_ref)           # the layer's box keeps its gradient
            reference_points = new_ref.detach()
            hs.append(output)
            refs.append(reference_points)
        return torch.stack(hs), memory, init_reference, torch.stack(refs), torch.stack(coords)
