"""IDOL meta-architecture (ResNet-50 backbone): training and inference.

Counterpart of ``vnext_tpu.models.idol.IDOL``: backbone, input projections with
sine positions, the deformable transformer with box refinement, the class / box
/ ReID heads and the CondInst dynamic mask head. Public layouts are the JAX
package's. ``inference`` takes one clip of frames as the batch: images
[T, H, W, 3] and sizes [T, 2] (valid h, w) in; ``pred_logits [T, Q, C]``,
``pred_boxes [T, Q, 4]``, ``pred_inst_embed [T, Q, E]``, ``pred_masks [T, Q, H/4, W/4]``
out. ``forward`` is the train forward of ``IDOL.__call__``: a key and a
reference frame per clip with their padded targets in, the loss dict out.
Module and parameter names follow the flax tree.

The module's mode picks the path, as the JAX package's ``train`` flag does:
eval mode runs the fused inference kernels, train mode the MSDA standard entry
(with a backward), the unfused encoder tail and dropout. ``msda_impl``
(``cfg.TPU.MSDA_IMPL``) picks the MSDA route as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from .backbones.resnet import ResNet
from .condinst import MaskHeadSmallConv, num_dynamic_params, run_dynamic_mask_head
from .criterion import Targets, loss_boxes, loss_labels, loss_masks, loss_reid
from .deformable_transformer import DeformableTransformer
from .layers import MLP, ConvGN, Dense, init_weights
from .matcher import match, pos_neg_masks
from .position_encoding import sine_position_embedding

FEATURE_STRIDES = (8, 16, 32, 64)
BACKBONE_CHANNELS = (512, 1024, 2048)   # res3, res4, res5 of ResNet-50
CLASS_PRIOR = 0.01


class DeformableVIS(nn.Module):
    """What IDOL and SeqFormer share around their transformers: the input
    projections with sine positions over the valid region, and the mask head's
    features from the encoder memory. A subclass holds ``num_feature_levels``,
    ``hidden_dim``, ``dtype``, ``input_proj_{i}`` and ``mask_head``."""

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
        """The 3 finest levels of the flattened memory [B, S, C], fused by the mask head."""
        feats, start = [], 0
        b = memory.shape[0]
        for h, w in spatial_shapes[:3]:
            feats.append(memory[:, start:start + h * w].transpose(1, 2).reshape(b, -1, h, w))
            start += h * w
        return self.mask_head(feats)


class IDOL(DeformableVIS):
    """Defaults are IDOL-R50 as ``configs/idol/ytvis19_r50.yaml`` configures it."""

    def __init__(self, num_classes: int = 40, hidden_dim: int = 256, num_queries: int = 300,
                 nheads: int = 8, dim_feedforward: int = 1024, enc_layers: int = 6,
                 dec_layers: int = 6, num_feature_levels: int = 4, enc_n_points: int = 4,
                 dec_n_points: int = 4, backbone_depth: int = 50, mask_out_stride: int = 4,
                 dropout: float = 0.1, max_insts: int = 48, dtype=torch.float32,
                 msda_impl: str = "auto"):
        super().__init__()
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
            in_ch = BACKBONE_CHANNELS[min(i, 2)] if i <= 3 else hidden_dim
            self.add_module(f"input_proj_{i}", ConvGN(
                in_ch, hidden_dim, 3 if extra else 1, 2 if extra else 1, dtype=dtype))
        self.transformer = DeformableTransformer(
            hidden_dim, nheads, enc_layers, dec_layers, dim_feedforward, num_feature_levels,
            enc_n_points, dec_n_points, dtype, dropout=dropout, msda_impl=msda_impl)
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

    def _trunk(self, images: torch.Tensor, image_sizes: torch.Tensor,
               base_feats: Optional[List[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None) -> Dict:
        """Backbone, transformer and every decoder layer's boxes for one batch of
        frames [B, H, W, 3] (normalized f32); no class heads."""
        if base_feats is None:
            feats = self.backbone(images)
            base_feats = [feats["res3"], feats["res4"], feats["res5"]]
        srcs, valid_hw, poses = self.project_features(base_feats, image_sizes)
        spatial_shapes = tuple((int(s.shape[1]), int(s.shape[2])) for s in srcs)
        hs, memory, init_ref, inter_refs, out_coords = self.transformer(
            srcs, valid_hw, poses, self.query_embed, generator)
        # reference points (sigmoid space) before each decoder layer; the first
        # is not detached, so the mask head's coordinates train it
        pre_refs = [init_ref[..., :2]] + [inter_refs[i][..., :2] for i in range(self.dec_layers - 1)]
        return {
            "hs": hs,                        # [L, B, Q, C]
            "memory": memory,                # [B, S, C]
            "boxes": out_coords,             # [L, B, Q, 4] cxcywh, not detached
            "pre_refs": pre_refs,            # L x [B, Q, 2]
            "spatial_shapes": spatial_shapes,
        }

    def _class_logits(self, hs: torch.Tensor, layer: int) -> torch.Tensor:
        return getattr(self, f"class_embed_{layer}")(hs).float()

    def forward_single(self, images: torch.Tensor, image_sizes: torch.Tensor,
                       base_feats: Optional[List[torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None) -> Dict:
        """The trunk's outputs and every decoder layer's class logits
        ``logits`` [L, B, Q, classes] f32, as the train forward uses them."""
        out = self._trunk(images, image_sizes, base_feats, generator)
        out["logits"] = torch.stack([self._class_logits(out["hs"][i], i)
                                     for i in range(self.dec_layers)])
        return out

    # ------------------------------------------------------------ training
    def forward(self, key_images: torch.Tensor, key_sizes: torch.Tensor,
                ref_images: torch.Tensor, ref_sizes: torch.Tensor,
                det_targets: Targets, ref_targets: Targets,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The train forward: losses of every decoder layer on the key frames
        (simOTA matching on detached outputs, focal / L1 / GIoU, and the dynamic
        mask head on ``max_insts`` matched-instance slots), and the contrastive
        ReID loss between the key and the reference frames on the last layer."""
        out_key = self.forward_single(key_images, key_sizes, generator=generator)
        out_ref = self.forward_single(ref_images, ref_sizes, generator=generator)

        mask_feats = self._mask_features(out_key["memory"], out_key["spatial_shapes"])
        scale = key_sizes.flip(-1).float()[:, None, :]                       # (w, h)
        losses: Dict[str, torch.Tensor] = {}
        last_match = None
        for lvl in range(self.dec_layers):
            logits_l, boxes_l = out_key["logits"][lvl], out_key["boxes"][lvl]
            m = match(logits_l.detach(), boxes_l.detach(), det_targets.labels,
                      det_targets.boxes, det_targets.valid)
            last_match = m
            suffix = "" if lvl == self.dec_layers - 1 else f"_{lvl}"
            losses[f"loss_ce{suffix}"] = loss_labels(logits_l, m, det_targets, self.num_classes)
            for k, v in loss_boxes(boxes_l, m, det_targets).items():
                losses[f"{k}{suffix}"] = v

            # fixed-capacity matched-instance slots, matched queries first in
            # query order (lax.top_k's order: a stable sort)
            inst_query = torch.sort(m.selected_query.float(), dim=1, descending=True,
                                    stable=True).indices[:, :self.max_insts]   # [B, N]
            inst_valid = torch.gather(m.selected_query, 1, inst_query)
            inst_gt = torch.gather(m.gt_index, 1, inst_query)
            params = self.controller(out_key["hs"][lvl])                        # [B, Q, P]
            params_sel = torch.gather(params, 1, inst_query[..., None].expand(-1, -1, params.shape[-1]))
            ref_pts = torch.gather(out_key["pre_refs"][lvl] * scale, 1,
                                   inst_query[..., None].expand(-1, -1, 2))
            mask_logits = run_dynamic_mask_head(
                mask_feats, ref_pts, params_sel, mask_feat_stride=8,
                mask_out_stride=self.mask_out_stride)
            for k, v in loss_masks(mask_logits, inst_gt, inst_valid, det_targets).items():
                losses[f"{k}{suffix}"] = v

        key_embeds = self.reid_embed(out_key["hs"][-1])
        ref_embeds = self.reid_embed(out_ref["hs"][-1])
        ref_cls = torch.sigmoid(out_ref["logits"][-1].detach())
        ref_box = out_ref["boxes"][-1].detach()
        item_valid = det_targets.valid & ref_targets.valid
        pos_mask, neg_mask = pos_neg_masks(ref_cls, ref_box, ref_targets.labels,
                                           ref_targets.boxes, item_valid)
        losses.update(loss_reid(key_embeds, ref_embeds, last_match.matched_query_per_gt,
                                pos_mask, neg_mask, item_valid))
        return losses

    # ------------------------------------------------------------ inference
    def inference(self, images: torch.Tensor, image_sizes: torch.Tensor,
                  base_feats: Optional[List[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """images [T, H, W, 3] normalized f32; image_sizes [T, 2] valid (h, w)."""
        out = self._trunk(images, image_sizes, base_feats)
        last = out["hs"][-1]
        mask_feats = self._mask_features(out["memory"], out["spatial_shapes"])
        scale = image_sizes.flip(-1).float()[:, None, :]               # (w, h)
        masks = run_dynamic_mask_head(
            mask_feats, out["pre_refs"][-1] * scale, self.controller(last), mask_feat_stride=8,
            mask_out_stride=self.mask_out_stride)
        return {
            "pred_logits": self._class_logits(last, self.dec_layers - 1),
            "pred_boxes": out["boxes"][-1],
            "pred_inst_embed": self.reid_embed(last),
            "pred_masks": masks,
        }


def idol_kwargs_from_cfg(cfg) -> dict:
    """IDOL constructor arguments from a config node with the JAX package's keys
    (``MODEL.IDOL.*``, ``MODEL.RESNETS.*``, ``TPU.COMPUTE_DTYPE``,
    ``TPU.MSDA_IMPL``); the port reads
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
        dropout=c.DROPOUT, max_insts=cfg.TPU.MAX_INSTANCES,
        dtype=torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32,
        msda_impl=cfg.TPU.MSDA_IMPL,
    )


def build_idol_model(cfg=None, device="cuda", dtype=None, seed: int = 0,
                     dropout: Optional[float] = None) -> IDOL:
    """IDOL in eval mode on ``device`` with seeded random weights.

    The card is the default; with no CUDA device this raises rather than fall
    back to the CPU, which runs the kernels' plain versions only when the
    caller asks for it (``device="cpu"``). Without ``cfg`` the constructor
    defaults apply, which are IDOL-R50 as ``configs/idol/ytvis19_r50.yaml`` sets
    it (bf16 compute). ``dtype`` and ``dropout`` override the compute dtype and
    the dropout rate of either.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_idol_model: no CUDA device is visible; pass device='cpu' "
                           "to run the plain versions on the CPU")
    kwargs = idol_kwargs_from_cfg(cfg) if cfg is not None else {"dtype": torch.bfloat16}
    if dtype is not None:
        kwargs["dtype"] = dtype
    if dropout is not None:
        kwargs["dropout"] = dropout
    model = IDOL(**kwargs)
    init_weights(model, seed)
    return model.to(device).eval()
