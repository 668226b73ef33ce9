"""IDOL meta-architecture, inference path (ResNet-50 backbone).

Counterpart of ``vnext_tpu.models.idol.IDOL.inference``: backbone, input
projections with sine positions, the deformable transformer with box
refinement, the class / box / ReID heads and the CondInst dynamic mask head, for
one clip of frames as the batch. Public layouts are the JAX package's: images
[T, H, W, 3] and sizes [T, 2] (valid h, w) in; ``pred_logits [T, Q, C]``,
``pred_boxes [T, Q, 4]``, ``pred_inst_embed [T, Q, E]``, ``pred_masks [T, Q, H/4, W/4]``
out. Module and parameter names follow the flax tree.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from .backbones.resnet import ResNet
from .condinst import MaskHeadSmallConv, num_dynamic_params, run_dynamic_mask_head
from .deformable_transformer import DeformableTransformer
from .layers import MLP, ConvGN, Dense, init_weights
from .position_encoding import sine_position_embedding

FEATURE_STRIDES = (8, 16, 32, 64)
BACKBONE_CHANNELS = (512, 1024, 2048)   # res3, res4, res5 of ResNet-50
CLASS_PRIOR = 0.01


class IDOL(nn.Module):
    """Defaults are IDOL-R50 as ``configs/idol/ytvis19_r50.yaml`` configures it."""

    def __init__(self, num_classes: int = 40, hidden_dim: int = 256, num_queries: int = 300,
                 nheads: int = 8, dim_feedforward: int = 1024, enc_layers: int = 6,
                 dec_layers: int = 6, num_feature_levels: int = 4, enc_n_points: int = 4,
                 dec_n_points: int = 4, backbone_depth: int = 50, mask_out_stride: int = 4,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_feature_levels = num_feature_levels
        self.dec_layers = dec_layers
        self.hidden_dim = hidden_dim
        self.mask_out_stride = mask_out_stride
        self.backbone = ResNet(backbone_depth, dtype)
        for i in range(num_feature_levels):
            extra = i >= 3
            in_ch = BACKBONE_CHANNELS[min(i, 2)] if i <= 3 else hidden_dim
            self.add_module(f"input_proj_{i}", ConvGN(
                in_ch, hidden_dim, 3 if extra else 1, 2 if extra else 1, dtype=dtype))
        self.transformer = DeformableTransformer(
            hidden_dim, nheads, enc_layers, dec_layers, dim_feedforward, num_feature_levels,
            enc_n_points, dec_n_points, dtype)
        prior = -math.log((1 - CLASS_PRIOR) / CLASS_PRIOR)
        for i in range(dec_layers):
            self.add_module(f"class_embed_{i}", Dense(
                hidden_dim, num_classes, dtype, bias_init=lambda b: b.fill_(prior)))
        self.controller = MLP(hidden_dim, hidden_dim, num_dynamic_params(hidden_dim // 32), 3, dtype)
        self.mask_head = MaskHeadSmallConv(hidden_dim, dtype)
        self.reid_embed = MLP(hidden_dim, hidden_dim, hidden_dim, 3, dtype)
        self.query_embed = nn.Parameter(torch.empty(num_queries, 2 * hidden_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.query_embed, 0.0, 1.0, generator=gen)

    # ------------------------------------------------------------ features
    def project_features(self, base: List[torch.Tensor], image_sizes: torch.Tensor):
        """[res3, res4, res5] NCHW -> per-level srcs [B, H, W, C], valid (h, w), positions."""
        srcs, valid_hw, poses = [], [], []
        prev = None
        for lvl in range(self.num_feature_levels):
            proj = getattr(self, f"input_proj_{lvl}")
            prev = proj(base[lvl] if lvl < 3 else (base[2] if lvl == 3 else prev))
            h, w = prev.shape[2], prev.shape[3]
            stride = FEATURE_STRIDES[lvl]
            limit = torch.tensor([h, w], dtype=image_sizes.dtype, device=image_sizes.device)
            vhw = torch.minimum(torch.div(image_sizes + stride - 1, stride, rounding_mode="floor"), limit)
            pos = sine_position_embedding(vhw, h, w, num_pos_feats=self.hidden_dim // 2)
            srcs.append(prev.permute(0, 2, 3, 1))
            valid_hw.append(vhw)
            poses.append(pos.to(self.dtype))
        return srcs, valid_hw, poses

    def _mask_features(self, memory: torch.Tensor, spatial_shapes) -> torch.Tensor:
        """The 3 finest levels of the flattened memory, fused by the mask head."""
        feats, start = [], 0
        b = memory.shape[0]
        for h, w in spatial_shapes[:3]:
            feats.append(memory[:, start:start + h * w].transpose(1, 2).reshape(b, -1, h, w))
            start += h * w
        return self.mask_head(feats)

    # ------------------------------------------------------------ inference
    def inference(self, images: torch.Tensor, image_sizes: torch.Tensor,
                  base_feats: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """images [T, H, W, 3] normalized f32; image_sizes [T, 2] valid (h, w)."""
        if base_feats is None:
            feats = self.backbone(images)
            base_feats = [feats["res3"], feats["res4"], feats["res5"]]
        srcs, valid_hw, poses = self.project_features(base_feats, image_sizes)
        spatial_shapes = tuple((int(s.shape[1]), int(s.shape[2])) for s in srcs)
        hs, memory, init_ref, inter_refs, out_coords = self.transformer(
            srcs, valid_hw, poses, self.query_embed)
        last = hs[-1]
        logits = getattr(self, f"class_embed_{self.dec_layers - 1}")(last).float()
        mask_feats = self._mask_features(memory, spatial_shapes)
        params = self.controller(last)
        # reference points before the last decoder layer (sigmoid space)
        ref_pts = (init_ref if self.dec_layers == 1 else inter_refs[-2])[..., :2]
        scale = image_sizes.flip(-1).float()[:, None, :]               # (w, h)
        masks = run_dynamic_mask_head(
            mask_feats, ref_pts * scale, params, mask_feat_stride=8,
            mask_out_stride=self.mask_out_stride)
        return {
            "pred_logits": logits,
            "pred_boxes": out_coords[-1],
            "pred_inst_embed": self.reid_embed(last),
            "pred_masks": masks,
        }


def idol_kwargs_from_cfg(cfg) -> dict:
    """IDOL constructor arguments from a config node with the JAX package's keys
    (``MODEL.IDOL.*``, ``MODEL.RESNETS.*``, ``TPU.COMPUTE_DTYPE``); the port reads
    the node by attribute and does not import the JAX package."""
    if "swin" in cfg.MODEL.BACKBONE.NAME.lower():
        raise NotImplementedError("IDOL-Swin-L is not ported yet (ROADMAP Queue 1, Swin backbone)")
    if cfg.MODEL.RESNETS.STRIDE_IN_1X1:
        raise NotImplementedError("the port's ResNet has the stride on the 3x3 (STRIDE_IN_1X1=False)")
    c = cfg.MODEL.IDOL
    return dict(
        num_classes=c.NUM_CLASSES, hidden_dim=c.HIDDEN_DIM, num_queries=c.NUM_OBJECT_QUERIES,
        nheads=c.NHEADS, dim_feedforward=c.DIM_FEEDFORWARD, enc_layers=c.ENC_LAYERS,
        dec_layers=c.DEC_LAYERS, num_feature_levels=c.NUM_FEATURE_LEVELS,
        enc_n_points=c.ENC_N_POINTS, dec_n_points=c.DEC_N_POINTS,
        backbone_depth=cfg.MODEL.RESNETS.DEPTH, mask_out_stride=c.MASK_STRIDE,
        dtype=torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32,
    )


def build_idol_model(cfg=None, device="cpu", dtype=None, seed: int = 0) -> IDOL:
    """IDOL in eval mode on ``device`` with seeded random weights.

    Without ``cfg`` the constructor defaults apply, which are IDOL-R50 as
    ``configs/idol/ytvis19_r50.yaml`` sets it (bf16 compute). ``dtype``
    overrides the compute dtype of either.
    """
    kwargs = idol_kwargs_from_cfg(cfg) if cfg is not None else {"dtype": torch.bfloat16}
    if dtype is not None:
        kwargs["dtype"] = dtype
    model = IDOL(**kwargs)
    init_weights(model, seed)
    return model.to(device).eval()
