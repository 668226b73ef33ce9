"""SeqFormer meta-architecture (ResNet-50 backbone): offline clip inference.

Counterpart of ``vnext_tpu.models.seqformer``: one set of video-level instance
queries decodes every frame of a clip. The backbone and the encoder see the
frames folded into the batch; the decoder keeps a shared instance query and a
per-frame box query, samples every frame with a dual-output deformable cross
attention (one MSDA result, two output projections) and fuses the frames into
the instance query by a learned softmax over time. Public layouts are the JAX
package's: ``inference`` takes images [1, nf, H, W, 3] and sizes [1, 2] and
returns ``pred_logits [Q, C]``, ``pred_boxes [nf, Q, 4]`` and ``pred_masks
[Q, nf, H/4, W/4]``. Module and parameter names follow the flax tree.

The encoder is the port's token-major ``EncoderLayer``: in eval mode K1's point
form and K3 on the card (the JAX package runs its channel-major twin, the same
function). The decoder's cross attention runs the standard MSDA entry at batch
B * nf through the implementation selector (``msda_impl``): K4 on the card for
``auto``. Training (``__call__`` in the JAX package, with the clip-level
Hungarian matching) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from ..ops.ms_deform_attn import check_impl, ms_deform_attn_standard
from .backbones.resnet import ResNet
from .condinst import MaskHeadSmallConv, num_dynamic_params, run_dynamic_mask_head
from .deformable_transformer import (DeformableEncoder, bbox_embed, offset_bias_grid,
                                     refine_boxes, sampling_locations)
from .idol import BACKBONE_CHANNELS, CLASS_PRIOR, DeformableVIS
from .layers import MLP, ConvGN, Dense, LayerNorm, MultiHeadAttention, dropout, init_weights


class SeqFormerDecodeMSDA(nn.Module):
    """Dual-output per-frame deformable cross attention: projections, the MSDA
    core over the frames folded into the batch, and two output projections."""

    def __init__(self, d_model=256, n_levels=4, n_heads=8, n_points=4, dtype=torch.float32,
                 impl: str = "auto"):
        super().__init__()
        self.m, self.l, self.p = n_heads, n_levels, n_points
        self.impl = check_impl(impl)
        grid = torch.from_numpy(offset_bias_grid(n_heads, n_levels, n_points))
        self.value_proj = Dense(d_model, d_model, dtype)
        self.sampling_offsets = Dense(
            d_model, n_heads * n_levels * n_points * 2, dtype, kernel_init="zeros",
            bias_init=lambda b: b.copy_(grid),
        )
        self.attention_weights = Dense(d_model, n_heads * n_levels * n_points, dtype,
                                       kernel_init="zeros")
        self.output_proj = Dense(d_model, d_model, dtype)
        self.output_proj_box = Dense(d_model, d_model, dtype)

    def forward(self, query_box, reference_points, src, spatial_shapes, padding_mask=None):
        """query_box [B, nf, Q, C]; reference_points [B, nf, Q, L, 2|4] in [0, 1];
        src [B, nf, S, C]; padding_mask [B, nf, S] True on padding. Returns
        (output, output_box), each [B, nf, Q, C]."""
        b, nf, q, c = query_box.shape
        m, l, p = self.m, self.l, self.p
        value = self.value_proj(src)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        value = value.view(b * nf, src.shape[2], m, c // m)
        offsets = self.sampling_offsets(query_box).view(b, nf, q, m, l, p, 2)
        logits = self.attention_weights(query_box).view(b, nf, q, m, l * p)
        attn = torch.softmax(logits.float(), -1).to(value.dtype).view(b * nf, q, m, l, p)
        loc = sampling_locations(spatial_shapes, offsets, reference_points).view(b * nf, q, m, l, p, 2)
        out = ms_deform_attn_standard(value, spatial_shapes, loc, attn, self.impl).view(b, nf, q, c)
        return self.output_proj(out), self.output_proj_box(out)


class SeqFormerDecoderLayer(nn.Module):
    def __init__(self, d_model=256, d_ffn=1024, n_levels=4, n_heads=8, n_points=4,
                 dtype=torch.float32, msda_impl: str = "auto"):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, dtype)
        self.norm2 = LayerNorm(d_model, dtype)
        self.self_attn_box = MultiHeadAttention(d_model, n_heads, dtype)
        self.norm2_box = LayerNorm(d_model, dtype)
        self.cross_attn = SeqFormerDecodeMSDA(d_model, n_levels, n_heads, n_points, dtype, msda_impl)
        self.norm1_box = LayerNorm(d_model, dtype)
        self.linear1_box = Dense(d_model, d_ffn, dtype)
        self.linear2_box = Dense(d_ffn, d_model, dtype)
        self.norm3_box = LayerNorm(d_model, dtype)
        self.time_attention_weights = Dense(d_model, 1, dtype)
        self.norm1 = LayerNorm(d_model, dtype)
        self.linear1 = Dense(d_model, d_ffn, dtype)
        self.linear2 = Dense(d_ffn, d_model, dtype)
        self.norm3 = LayerNorm(d_model, dtype)

    def forward(self, tgt, tgt_box, query_pos, ref_input, src, spatial_shapes, padding_mask,
                first_layer: bool, rate: float = 0.0, generator=None):
        """tgt [B, Q, C] instance queries; tgt_box [B, Q, C] on the first layer,
        [B, nf, Q, C] after it; query_pos [B, Q, C]; ref_input [B, nf, Q, L, 2|4];
        src [B, nf, S, C]. Returns (tgt [B, Q, C], tgt_box [B, nf, Q, C])."""
        def drop(x):
            return dropout(x, rate, generator)

        b, q, c = tgt.shape
        nf = src.shape[1]

        qk = tgt + query_pos
        tgt = self.norm2(tgt + drop(self.self_attn(qk, qk, tgt)))

        # box-query self attention: shared on the first layer, per frame after it
        if first_layer:
            qb = tgt_box + query_pos
            tb = self.norm2_box(tgt_box + drop(self.self_attn_box(qb, qb, tgt_box)))   # [B, Q, C]
            tb_frames = tb[:, None].expand(b, nf, q, c)
            residual_box = tb[:, None]
        else:
            flat = tgt_box.reshape(b * nf, q, c)
            qp = query_pos[:, None].expand(b, nf, q, c).reshape(b * nf, q, c)
            tb = self.norm2_box(flat + drop(self.self_attn_box(flat + qp, flat + qp, flat)))
            tb_frames = residual_box = tb.view(b, nf, q, c)

        tgt2, tgt2_box = self.cross_attn(tb_frames + query_pos[:, None], ref_input, src,
                                         spatial_shapes, padding_mask)

        tgt_box = self.norm1_box(residual_box + drop(tgt2_box))
        ff = self.linear2_box(drop(torch.relu(self.linear1_box(tgt_box))))
        tgt_box = self.norm3_box(tgt_box + drop(ff))

        # learned time attention: a softmax over the frames (f32) fuses them
        tw = torch.softmax(self.time_attention_weights(tgt_box).float(), dim=1).to(tgt2.dtype)
        fused = (tgt2 * tw).sum(1)                                                     # [B, Q, C]

        tgt = self.norm1(tgt + drop(fused))
        ff = self.linear2(drop(torch.relu(self.linear1(tgt))))
        return self.norm3(tgt + drop(ff)), tgt_box


class SeqFormerTransformer(DeformableEncoder):
    """The deformable encoder over the frames folded into the batch, and the
    box-refining video decoder."""

    def __init__(self, d_model=256, n_heads=8, num_encoder_layers=6, num_decoder_layers=6,
                 d_ffn=1024, num_feature_levels=4, enc_n_points=4, dec_n_points=4,
                 dtype=torch.float32, *, dropout: float, msda_impl: str = "auto"):
        super().__init__(d_model, n_heads, num_encoder_layers, d_ffn, num_feature_levels,
                         enc_n_points, dtype, dropout, msda_impl)
        self.num_decoder_layers = num_decoder_layers
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_{i}", SeqFormerDecoderLayer(
                d_model, d_ffn, num_feature_levels, n_heads, dec_n_points, dtype, msda_impl))
        self.reference_points = Dense(d_model, 2, dtype, kernel_init="xavier")
        for i in range(num_decoder_layers):
            self.add_module(f"bbox_embed_{i}", bbox_embed(d_model, dtype, first=i == 0))

    def forward(self, srcs: List[torch.Tensor], valid_hw: List[torch.Tensor],
                pos_embeds: List[torch.Tensor], query_embed: torch.Tensor, nf: int,
                generator=None):
        """srcs / pos_embeds: L x [B*nf, H_l, W_l, C] (frames folded into the
        batch, frame-minor); valid_hw: L x [B*nf, 2]; query_embed [Q, 2C].
        Returns (hs [L, B, Q, C], hs_box [L, B, nf, Q, C], memory [B, nf, S, C],
        init_reference [B, nf, Q, 2], inter_refs [L, B, nf, Q, 4] detached,
        out_coords [L, B, nf, Q, 4])."""
        memory, spatial_shapes, mask_flat, valid_ratios = self.encode(
            srcs, valid_hw, pos_embeds, generator)
        bnf, s, c = memory.shape
        b = bnf // nf
        memory = memory.view(b, nf, s, c)
        mask_flat = mask_flat.view(b, nf, s)
        valid_ratios = valid_ratios.view(b, nf, -1, 2)[:, 0]          # [B, L, 2], shared by the frames

        query_pos, tgt = torch.split(query_embed, query_embed.shape[1] // 2, dim=1)
        query_pos = query_pos[None].expand(b, -1, -1).to(self.dtype)
        output = output_box = tgt[None].expand(b, -1, -1).to(self.dtype)
        ref = torch.sigmoid(self.reference_points(query_pos).float())      # [B, Q, 2]
        reference_points = init_reference = ref[:, None].expand(b, nf, *ref.shape[1:])
        rate = self.dropout_rate if self.training else 0.0

        hs, hs_box, refs, coords = [], [], [], []
        for lid in range(self.num_decoder_layers):
            ratios = valid_ratios if reference_points.shape[-1] == 2 else torch.cat([valid_ratios] * 2, -1)
            ref_input = reference_points[:, :, :, None] * ratios[:, None, None]
            output, output_box = getattr(self, f"decoder_{lid}")(
                output, output_box, query_pos, ref_input, memory, spatial_shapes, mask_flat,
                lid == 0, rate, generator)
            new_ref = refine_boxes(getattr(self, f"bbox_embed_{lid}")(output_box), reference_points)
            coords.append(new_ref)
            reference_points = new_ref.detach()
            hs.append(output)
            hs_box.append(output_box)
            refs.append(reference_points)
        return (torch.stack(hs), torch.stack(hs_box), memory, init_reference,
                torch.stack(refs), torch.stack(coords))


class SeqFormer(DeformableVIS):
    """Defaults are SeqFormer-R50 as ``configs/seqformer/ytvis19_r50.yaml`` with
    ``add_seqformer_config`` configures it."""

    def __init__(self, num_classes: int = 40, hidden_dim: int = 256, num_queries: int = 300,
                 nheads: int = 8, dim_feedforward: int = 1024, enc_layers: int = 6,
                 dec_layers: int = 6, num_feature_levels: int = 4, enc_n_points: int = 4,
                 dec_n_points: int = 4, backbone_depth: int = 50, mask_out_stride: int = 4,
                 dropout: float = 0.1, max_insts: int = 24, dtype=torch.float32,
                 msda_impl: str = "auto"):
        super().__init__()
        if num_feature_levels > 4:
            raise NotImplementedError("SeqFormer projects res5 to every level past the third; "
                                      "the port runs 4 levels")
        self.dtype = dtype
        self.num_classes = num_classes
        self.max_insts = max_insts
        self.num_feature_levels = num_feature_levels
        self.dec_layers = dec_layers
        self.hidden_dim = hidden_dim
        self.mask_out_stride = mask_out_stride
        self.backbone = ResNet(backbone_depth, dtype)
        for i in range(num_feature_levels):
            extra = i >= 3
            in_ch = BACKBONE_CHANNELS[min(i, 2)]
            self.add_module(f"input_proj_{i}", ConvGN(
                in_ch, hidden_dim, 3 if extra else 1, 2 if extra else 1, dtype=dtype))
        self.transformer = SeqFormerTransformer(
            hidden_dim, nheads, enc_layers, dec_layers, dim_feedforward, num_feature_levels,
            enc_n_points, dec_n_points, dtype, dropout=dropout, msda_impl=msda_impl)
        prior = -math.log((1 - CLASS_PRIOR) / CLASS_PRIOR)
        for i in range(dec_layers):
            self.add_module(f"class_embed_{i}", Dense(
                hidden_dim, num_classes, dtype, bias_init=lambda b: b.fill_(prior)))
        self.controller = MLP(hidden_dim, hidden_dim, num_dynamic_params(hidden_dim // 32), 3, dtype)
        self.mask_head = MaskHeadSmallConv(hidden_dim, dtype)
        self.query_embed = nn.Parameter(torch.empty(num_queries, 2 * hidden_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.query_embed, 0.0, 1.0, generator=gen)

    # ------------------------------------------------------------ features
    def extract_features(self, images: torch.Tensor, image_sizes: torch.Tensor):
        """images [B, nf, H, W, 3] (normalized f32); image_sizes [B, 2], shared by
        the clip. Returns per-level srcs and positions [B*nf, H_l, W_l, C] and the
        valid (h, w) [B*nf, 2], frames folded into the batch."""
        b, nf = images.shape[:2]
        feats = self.backbone(images.flatten(0, 1))
        base = [feats["res3"], feats["res4"], feats["res5"]]
        return self.project_features(base, image_sizes.repeat_interleave(nf, 0))

    def _trunk(self, images: torch.Tensor, image_sizes: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> Dict:
        """Backbone, transformer and every decoder layer's boxes for clips
        [B, nf, H, W, 3] (normalized f32); no class heads."""
        nf = images.shape[1]
        srcs, valid_hw, poses = self.extract_features(images, image_sizes)
        spatial_shapes = tuple((int(s.shape[1]), int(s.shape[2])) for s in srcs)
        hs, hs_box, memory, init_ref, inter_refs, out_coords = self.transformer(
            srcs, valid_hw, poses, self.query_embed, nf, generator)
        pre_refs = [init_ref[..., :2]] + [inter_refs[i][..., :2] for i in range(self.dec_layers - 1)]
        return {
            "hs": hs,                        # [L, B, Q, C]
            "hs_box": hs_box,                # [L, B, nf, Q, C]
            "memory": memory,                # [B, nf, S, C]
            "boxes": out_coords,             # [L, B, nf, Q, 4] cxcywh
            "pre_refs": pre_refs,            # L x [B, nf, Q, 2]
            "spatial_shapes": spatial_shapes,
        }

    def _class_logits(self, hs: torch.Tensor, layer: int) -> torch.Tensor:
        return getattr(self, f"class_embed_{layer}")(hs).float()

    def forward_single(self, images: torch.Tensor, image_sizes: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> Dict:
        """The trunk's outputs and every decoder layer's class logits
        ``logits`` [L, B, Q, classes] f32, as the train forward uses them."""
        out = self._trunk(images, image_sizes, generator)
        out["logits"] = torch.stack([self._class_logits(out["hs"][i], i)
                                     for i in range(self.dec_layers)])
        return out

    def _clip_masks(self, mask_feats, pre_ref, params, image_sizes, nf: int):
        """The dynamic mask head of each instance on every frame of its clip.
        mask_feats [B*nf, Cm, H8, W8]; pre_ref [B, nf, N, 2] normalized; params
        [B, N, P]. Returns [B, N, nf, H4, W4]."""
        b, _, n, _ = pre_ref.shape
        scale = image_sizes.flip(-1).float()[:, None, None, :]                  # (w, h)
        ref_abs = (pre_ref * scale).reshape(b * nf, n, 2)
        params_f = params[:, None].expand(b, nf, n, params.shape[-1]).reshape(b * nf, n, -1)
        logits = run_dynamic_mask_head(mask_feats, ref_abs, params_f, mask_feat_stride=8,
                                       mask_out_stride=self.mask_out_stride)   # [B*nf, N, H4, W4]
        return logits.view(b, nf, n, *logits.shape[-2:]).transpose(1, 2)

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "SeqFormer training (clip-level Hungarian matching and its losses) is not ported yet: "
            "ROADMAP Queue 1, item 11")

    # ------------------------------------------------------------ inference
    def inference(self, images: torch.Tensor, image_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Whole-clip inference: images [1, nf, H, W, 3] normalized f32,
        image_sizes [1, 2] valid (h, w). Returns pred_logits [Q, C] f32,
        pred_boxes [nf, Q, 4] f32 and pred_masks [Q, nf, H/4, W/4]."""
        nf = images.shape[1]
        out = self._trunk(images, image_sizes)
        last = out["hs"][-1]
        mask_feats = self._mask_features(out["memory"].flatten(0, 1), out["spatial_shapes"])
        masks = self._clip_masks(mask_feats, out["pre_refs"][-1], self.controller(last), image_sizes, nf)
        return {
            "pred_logits": self._class_logits(last, self.dec_layers - 1)[0],
            "pred_boxes": out["boxes"][-1][0],
            "pred_masks": masks[0],
        }


def seqformer_kwargs_from_cfg(cfg) -> dict:
    """SeqFormer constructor arguments from a config node with the JAX package's
    keys (``MODEL.SeqFormer.*``, ``MODEL.RESNETS.*``, ``TPU.COMPUTE_DTYPE``,
    ``TPU.MAX_INSTANCES``, ``TPU.MSDA_IMPL``), read by attribute."""
    if "swin" in cfg.MODEL.BACKBONE.NAME.lower():
        raise NotImplementedError("SeqFormer-Swin-L is not ported yet (ROADMAP Queue 1, Swin backbone)")
    if cfg.MODEL.RESNETS.STRIDE_IN_1X1:
        raise NotImplementedError("the port's ResNet has the stride on the 3x3 (STRIDE_IN_1X1=False)")
    c = cfg.MODEL.SeqFormer
    return dict(
        num_classes=c.NUM_CLASSES, hidden_dim=c.HIDDEN_DIM, num_queries=c.NUM_OBJECT_QUERIES,
        nheads=c.NHEADS, dim_feedforward=c.DIM_FEEDFORWARD, enc_layers=c.ENC_LAYERS,
        dec_layers=c.DEC_LAYERS, num_feature_levels=c.NUM_FEATURE_LEVELS,
        enc_n_points=c.ENC_N_POINTS, dec_n_points=c.DEC_N_POINTS,
        backbone_depth=cfg.MODEL.RESNETS.DEPTH, mask_out_stride=c.MASK_STRIDE,
        dropout=c.DROPOUT, max_insts=cfg.TPU.MAX_INSTANCES,
        dtype=torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32,
        msda_impl=cfg.TPU.MSDA_IMPL,
    )


def build_seqformer_model(cfg=None, device="cuda", dtype=None, seed: int = 0) -> SeqFormer:
    """SeqFormer in eval mode on ``device`` with seeded random weights.

    The card is the default; with no CUDA device this raises rather than fall
    back to the CPU, which runs the kernels' plain versions only when the
    caller asks for it (``device="cpu"``). Without ``cfg`` the constructor
    defaults apply, which are SeqFormer-R50 as ``configs/seqformer/ytvis19_r50.yaml``
    sets it (bf16 compute); ``dtype`` overrides the compute dtype of either.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_seqformer_model: no CUDA device is visible; pass device='cpu' "
                           "to run the plain versions on the CPU")
    kwargs = seqformer_kwargs_from_cfg(cfg) if cfg is not None else {"dtype": torch.bfloat16}
    if dtype is not None:
        kwargs["dtype"] = dtype
    model = SeqFormer(**kwargs)
    init_weights(model, seed)
    return model.to(device).eval()
