"""Mask2Former (ResNet-50/101/152 or Swin backbone): frame training and inference, and MinVIS frame matching.

Counterpart of ``vnext_tpu.models.mask2former``: the deformable pixel decoder
(its encoder layers are the port's ``EncoderLayer`` over 3 levels, so in eval
mode on the card they run the fused MSDA kernel (K1) and the encoder epilogue
(K3)), the masked-attention transformer decoder with a class and mask
prediction before its first layer and after each, and MinVIS's query alignment
across frames. Public layouts are the JAX package's: ``inference`` takes frames
[T, H, W, 3] (normalized f32) and returns ``pred_logits [T, Q, C+1]`` f32,
``pred_masks [T, Q, H/4, W/4]`` f32 and ``pred_embds [T, Q, C]``. Module and
parameter names follow the flax tree.

``forward`` is the train forward of ``MaskFormer.__call__``: frames [B, H, W,
3] with their padded ``MaskTargets`` in, the loss dict out. Each of the
``dec_layers`` + 1 predictions is matched alone (class, mask BCE and dice cost,
solved on the host in one copy for all of them) and scored by the softmax CE
with the no-object weight and the mask BCE and dice, point-sampled
(``TRAIN_NUM_POINTS`` > 0, the draws from the caller's generator) or dense. In
train mode the pixel decoder's encoder takes the MSDA standard entry (K4 and
K5 on the card) at dropout 0, as the JAX package's does. The pixel decoder is
token-major only: the JAX package's channel-major twin of its eval encoder is
a TPU relayout and computes the same function.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.hungarian import assign_batched
from ..ops.interpolate import resize_bilinear
from ..ops.losses import dice_loss, sigmoid_bce_with_logits
from ..ops.point_sample import sampled_mask_losses
from ..parallel.mesh import global_count
from .backbones import SWIN_PRESETS, backbone_features, backbone_kwargs_from_cfg, make_backbone
from .deformable_transformer import EncoderLayer, encoder_reference_points
from .layers import MLP, Conv, Dense, GroupNorm, LayerNorm, MultiHeadAttention, init_weights
from .position_encoding import sine_position_embedding

# the pixel decoder's levels, coarsest first (the reference reverses its
# transformer_in_features): input_proj_0 and level_embed[0] belong to res5
DECODER_LEVELS = ("res5", "res4", "res3")
RES_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}   # ResNet-50/101/152


class MaskTargets(NamedTuple):
    """Padded per-frame ground truth; K is the fixed instance capacity."""

    labels: torch.Tensor     # [B, K] int class ids (padding arbitrary)
    masks_s4: torch.Tensor   # [B, K, H/4, W/4] bool
    valid: torch.Tensor      # [B, K] bool


def _full_positions(b: int, h: int, w: int, c: int, device) -> torch.Tensor:
    """[B, H, W, C] f32 sine positions with every pixel valid, in the
    plain-cumsum convention (offset 1.0) Mask2Former uses."""
    vhw = torch.tensor([[h, w]], dtype=torch.int32, device=device).expand(b, 2)
    return sine_position_embedding(vhw, h, w, num_pos_feats=c // 2, offset=1.0)


class MSDeformAttnPixelDecoder(nn.Module):
    """Deformable encoder over strides 32 / 16 / 8, then fusion to the stride-4
    mask features."""

    def __init__(self, hidden_dim: int = 256, mask_dim: int = 256, num_encoder_layers: int = 6,
                 n_heads: int = 8, n_points: int = 4, dtype=torch.float32, msda_impl: str = "auto",
                 in_channels: Dict[str, int] = RES_CHANNELS):
        super().__init__()
        self.hidden_dim, self.dtype = hidden_dim, dtype
        self.num_encoder_layers = num_encoder_layers
        for lvl, name in enumerate(DECODER_LEVELS):
            self.add_module(f"input_proj_{lvl}", Conv(in_channels[name], hidden_dim, 1, dtype=dtype))
            self.add_module(f"input_norm_{lvl}", GroupNorm(32, hidden_dim, dtype))
        self.level_embed = nn.Parameter(torch.empty(len(DECODER_LEVELS), hidden_dim))
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_{i}", EncoderLayer(
                hidden_dim, hidden_dim * 4, len(DECODER_LEVELS), n_heads, n_points, dtype, msda_impl))
        # the reference's lateral and output convolutions carry GroupNorm, hence no bias
        self.adapter_res2 = Conv(in_channels["res2"], hidden_dim, 1, bias=False, dtype=dtype)
        self.adapter_norm = GroupNorm(32, hidden_dim, dtype)
        self.output_conv = Conv(hidden_dim, hidden_dim, 3, padding=1, bias=False, dtype=dtype)
        self.output_norm = GroupNorm(32, hidden_dim, dtype)
        self.mask_features = Conv(hidden_dim, mask_dim, 1, dtype=dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.normal_(self.level_embed, 0.0, 1.0, generator=gen)

    def project(self, feats: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        """The input projections: res5, res4, res3 NCHW -> 3 x [B, C, h, w]."""
        return [getattr(self, f"input_norm_{lvl}")(getattr(self, f"input_proj_{lvl}")(feats[name]))
                for lvl, name in enumerate(DECODER_LEVELS)]

    def forward(self, feats: Dict[str, torch.Tensor], srcs: Optional[List[torch.Tensor]] = None):
        """feats: res2..res5 NCHW. Returns (mask_features [B, mask_dim, H/4, W/4],
        multi_scale: 3 x [B, h, w, C] coarsest first). ``srcs`` (3 x [B, C, h, w])
        replaces the input projections' outputs."""
        if srcs is None:
            srcs = self.project(feats)
        b, c = srcs[0].shape[0], self.hidden_dim
        spatial_shapes = tuple((int(s.shape[2]), int(s.shape[3])) for s in srcs)
        src_flat, pos_flat = [], []
        for lvl, (src, (h, w)) in enumerate(zip(srcs, spatial_shapes)):
            pos = _full_positions(b, h, w, c, src.device).to(self.dtype)
            src_flat.append(src.flatten(2).transpose(1, 2))
            pos_flat.append(pos.reshape(b, h * w, c) + self.level_embed[lvl].to(pos.dtype))
        memory = torch.cat(src_flat, 1)
        pos_flat = torch.cat(pos_flat, 1)
        valid_ratios = torch.ones(b, len(spatial_shapes), 2, device=memory.device)
        enc_ref = encoder_reference_points(spatial_shapes, valid_ratios)
        # the reference's pixel decoder has no padding: no mask on the values
        for i in range(self.num_encoder_layers):
            memory = getattr(self, f"encoder_{i}")(memory, pos_flat, enc_ref, spatial_shapes, None)

        outs, start = [], 0
        for h, w in spatial_shapes:
            outs.append(memory[:, start:start + h * w].reshape(b, h, w, c))
            start += h * w

        # FPN fusion of the stride-8 level (the last, coarsest-first) with res2
        lateral = self.adapter_norm(self.adapter_res2(feats["res2"]))
        up = resize_bilinear(outs[-1].permute(0, 3, 1, 2), lateral.shape[2], lateral.shape[3]).to(self.dtype)
        y = torch.relu(self.output_norm(self.output_conv(lateral + up)))
        return self.mask_features(y), outs


class MaskedTransformerDecoder(nn.Module):
    """Masked-attention decoder with a class and mask prediction before its
    first layer and after each; the layers rotate over the 3 levels."""

    def __init__(self, num_classes: int, hidden_dim: int = 256, num_queries: int = 100,
                 n_heads: int = 8, dim_feedforward: int = 2048, dec_layers: int = 9,
                 mask_dim: int = 256, dtype=torch.float32):
        super().__init__()
        c = hidden_dim
        self.hidden_dim, self.num_queries, self.dec_layers, self.dtype = c, num_queries, dec_layers, dtype
        self.query_feat = nn.Parameter(torch.empty(num_queries, c))
        self.query_embed = nn.Parameter(torch.empty(num_queries, c))
        self.dec_level_embed = nn.Parameter(torch.empty(len(DECODER_LEVELS), c))
        self.decoder_norm = LayerNorm(c, dtype)
        self.class_embed = Dense(c, num_classes + 1, dtype)
        self.mask_embed = MLP(c, c, mask_dim, 3, dtype)
        for i in range(dec_layers):
            self.add_module(f"cross_{i}", MultiHeadAttention(c, n_heads, dtype))
            self.add_module(f"cross_norm_{i}", LayerNorm(c, dtype))
            self.add_module(f"self_{i}", MultiHeadAttention(c, n_heads, dtype))
            self.add_module(f"self_norm_{i}", LayerNorm(c, dtype))
            self.add_module(f"ffn1_{i}", Dense(c, dim_feedforward, dtype))
            self.add_module(f"ffn2_{i}", Dense(dim_feedforward, c, dtype))
            self.add_module(f"ffn_norm_{i}", LayerNorm(c, dtype))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for p in (self.query_feat, self.query_embed, self.dec_level_embed):
            nn.init.normal_(p, 0.0, 1.0, generator=gen)

    def predict(self, output: torch.Tensor, mask_features: torch.Tensor, target_size: Tuple[int, int]):
        """(class logits [B, Q, C+1] f32, mask logits [B, Q, H/4, W/4] f32, the
        next layer's attention mask [B, Q, h*w], True where a query may not look).
        A query whose mask covers nothing would make a softmax of -1e9 alone: it
        looks everywhere instead."""
        b = output.shape[0]
        x = self.decoder_norm(output)
        logits = self.class_embed(x).float()
        masks = torch.einsum("bqc,bchw->bqhw", self.mask_embed(x), mask_features).float()
        am = resize_bilinear(masks, *target_size)
        attn_mask = torch.sigmoid(am).reshape(b, self.num_queries, -1) < 0.5
        attn_mask = attn_mask & ~attn_mask.all(-1, keepdim=True)
        return logits, masks, attn_mask

    def forward(self, multi_scale: List[torch.Tensor], mask_features: torch.Tensor):
        """multi_scale: 3 x [B, h, w, C]; mask_features [B, mask_dim, H/4, W/4].
        Returns (logits per prediction, masks per prediction, attention masks
        per layer, query embeddings [B, Q, C]): ``dec_layers`` + 1 predictions,
        the last the decoder's output."""
        b, c, q = mask_features.shape[0], self.hidden_dim, self.num_queries
        srcs, keys, sizes = [], [], []
        for lvl, f in enumerate(multi_scale):
            h, w = f.shape[1:3]
            pos = _full_positions(b, h, w, c, f.device).to(self.dtype).reshape(b, h * w, c)
            src = f.reshape(b, h * w, c) + self.dec_level_embed[lvl].to(f.dtype)
            srcs.append(src)
            keys.append(src + pos)
            sizes.append((h, w))
        output = self.query_feat[None].expand(b, q, c).to(self.dtype)
        qpos = self.query_embed[None].expand(b, q, c).to(self.dtype)

        logits, masks, attn_mask = self.predict(output, mask_features, sizes[0])
        pred_logits, pred_masks, attn_masks = [logits], [masks], []
        for i in range(self.dec_layers):
            lvl = i % len(sizes)
            attn_masks.append(attn_mask)
            ca = getattr(self, f"cross_{i}")(output + qpos, keys[lvl], srcs[lvl], mask=~attn_mask[:, None])
            output = getattr(self, f"cross_norm_{i}")(output + ca)
            sa = getattr(self, f"self_{i}")(output + qpos, output + qpos, output)
            output = getattr(self, f"self_norm_{i}")(output + sa)
            ff = getattr(self, f"ffn2_{i}")(torch.relu(getattr(self, f"ffn1_{i}")(output)))
            output = getattr(self, f"ffn_norm_{i}")(output + ff)
            logits, masks, attn_mask = self.predict(output, mask_features, sizes[(i + 1) % len(sizes)])
            pred_logits.append(logits)
            pred_masks.append(masks)
        return pred_logits, pred_masks, attn_masks, self.decoder_norm(output)


def maskformer_match_cost(logits: torch.Tensor, masks: torch.Tensor, gt_labels: torch.Tensor,
                          gt_masks: torch.Tensor, gt_valid: torch.Tensor, cost_class: float = 2.0,
                          cost_mask: float = 5.0, cost_dice: float = 5.0) -> torch.Tensor:
    """[..., Q, K] matching cost of the class logits [..., Q, C+1] and mask
    logits [..., Q, H, W] against the labels [..., K] and masks [..., K, H, W]:
    -p(class), the mean BCE over the pixels and the dice distance, weighed; 1e9
    on invalid ground truth. Any leading dimensions are a batch."""
    probs = torch.softmax(logits.float(), -1)
    c_class = -torch.gather(probs, -1, gt_labels.long()[..., None, :].expand(*probs.shape[:-1], -1))
    m = masks.float().flatten(-2)
    g = gt_masks.float().flatten(-2)
    gt_t = g.transpose(-1, -2)
    pos = sigmoid_bce_with_logits(m, torch.ones_like(m)) @ gt_t
    neg = sigmoid_bce_with_logits(m, torch.zeros_like(m)) @ (1 - gt_t)
    c_mask = (pos + neg) / m.shape[-1]
    prob_m = torch.sigmoid(m)
    numer = 2 * (prob_m @ gt_t)
    denom = prob_m.sum(-1)[..., None] + g.sum(-1)[..., None, :]
    c_dice = 1 - (numer + 1) / (denom + 1)
    cost = cost_class * c_class + cost_mask * c_mask + cost_dice * c_dice
    return torch.where(gt_valid[..., None, :], cost, 1e9)


class MaskFormer(nn.Module):
    """Frame-level Mask2Former. The defaults are MinVIS-R50 as
    ``configs/minvis/ovis_r50.yaml`` configures it, with the config defaults'
    losses (no-object weight 0.1, deep supervision, 12544 sampled points)."""

    def __init__(self, num_classes: int = 25, hidden_dim: int = 256, num_queries: int = 100,
                 dec_layers: int = 9, enc_layers: int = 6, dim_feedforward: int = 2048,
                 backbone_type: str = "resnet", backbone_depth: int = 50, swin: tuple = SWIN_PRESETS["L"],
                 no_object_weight: float = 0.1, deep_supervision: bool = True, num_points: int = 12544,
                 dtype=torch.float32, msda_impl: str = "auto"):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.no_object_weight = no_object_weight
        self.deep_supervision = deep_supervision
        self.num_points = num_points
        self.backbone = make_backbone(backbone_type, depth=backbone_depth, swin=swin, dtype=dtype,
                                      out_features=("res2", "res3", "res4", "res5"))
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            hidden_dim, hidden_dim, enc_layers, dtype=dtype, msda_impl=msda_impl,
            in_channels=self.backbone.output_channels)
        self.transformer_decoder = MaskedTransformerDecoder(
            num_classes, hidden_dim, num_queries, dim_feedforward=dim_feedforward,
            dec_layers=dec_layers, mask_dim=hidden_dim, dtype=dtype)

    def forward_frames(self, images: torch.Tensor, feats: Optional[Dict[str, torch.Tensor]] = None,
                       srcs: Optional[List[torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None) -> Dict:
        """images [T, H, W, 3] normalized f32 -> every stage's outputs: ``feats``
        (the backbone's), ``mask_features``, ``multi_scale``, per-prediction
        ``logits`` and ``masks``, per-layer ``attn_masks`` and ``embeds``.
        ``feats`` / ``srcs`` replace the backbone's / the input projections'
        outputs; Swin's drop-path draws from ``generator`` in train mode."""
        if feats is None:
            feats = backbone_features(self.backbone, images, generator)
        mask_features, multi_scale = self.pixel_decoder(feats, srcs)
        logits, masks, attn_masks, embeds = self.transformer_decoder(multi_scale, mask_features)
        return {"feats": feats, "mask_features": mask_features, "multi_scale": multi_scale,
                "logits": logits, "masks": masks, "attn_masks": attn_masks, "embeds": embeds}

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor, targets: MaskTargets,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The train forward: frames [B, H, W, 3] (normalized f32), their valid
        sizes [B, 2] (unused, as in the JAX package) and targets -> the loss
        dict, ``loss_ce`` / ``loss_mask`` / ``loss_dice`` of the decoder's output
        and ``_{i}`` for prediction i before it (with deep supervision). The
        point draws (and Swin's drop-path masks, first) come from ``generator``."""
        out = self.forward_frames(images, generator=generator)
        logits_l, masks_l = out["logits"], out["masks"]
        last = len(logits_l) - 1
        layers = list(range(len(logits_l))) if self.deep_supervision else [last]
        cost = torch.stack([maskformer_match_cost(logits_l[i].detach(), masks_l[i].detach(), targets.labels,
                                                  targets.masks_s4, targets.valid) for i in layers])
        assignment = assign_batched(cost.transpose(-1, -2), targets.valid.expand(len(layers), -1, -1))
        losses: Dict[str, torch.Tensor] = {}
        for n, i in enumerate(layers):
            suffix = "" if i == last else f"_{i}"
            for k, v in self._losses(logits_l[i], masks_l[i], assignment[n], targets, generator).items():
                losses[f"{k}{suffix}"] = v
        return losses

    def _losses(self, logits, masks, assignment, targets: MaskTargets, generator):
        """Softmax CE (the no-object class weighed ``no_object_weight``) over
        every query, and the mask BCE and dice of each matched (query, gt)."""
        b, q, _ = logits.shape
        k = assignment.shape[1]
        q_idx = assignment.clamp(0, q - 1)
        valid = targets.valid & (assignment >= 0)

        target_classes = torch.full((b, q + 1), self.num_classes, dtype=torch.int64, device=logits.device)
        target_classes.scatter_(1, torch.where(valid, q_idx, q), targets.labels.long())
        target_classes = target_classes[:, :q]
        ce = -torch.gather(F.log_softmax(logits.float(), -1), -1, target_classes[..., None])[..., 0]
        w = torch.where(target_classes == self.num_classes, self.no_object_weight, 1.0)
        loss_ce = (ce * w).sum() / global_count(w.sum())

        hw = masks.shape[-2:]
        src_masks = torch.gather(masks.float(), 1, q_idx[..., None, None].expand(-1, -1, *hw))
        gt = targets.masks_s4.float()
        num = global_count(valid.sum())
        flat_valid = valid.reshape(-1)
        if self.num_points > 0:
            loss_mask, loss_dice = sampled_mask_losses(
                src_masks.reshape(b * k, *hw), gt.reshape(b * k, *hw), flat_valid, num,
                num_points=self.num_points, generator=generator)
        else:
            flat_src, flat_gt = src_masks.reshape(b * k, -1), gt.reshape(b * k, -1)
            loss_mask = (sigmoid_bce_with_logits(flat_src, flat_gt).mean(-1) * flat_valid).sum() / num
            loss_dice = dice_loss(flat_src, flat_gt, num, valid=flat_valid)
        return {"loss_ce": loss_ce, "loss_mask": loss_mask, "loss_dice": loss_dice}

    def inference(self, images: torch.Tensor, image_sizes: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        """images [T, H, W, 3] normalized f32 -> ``pred_logits`` [T, Q, C+1] f32,
        ``pred_masks`` [T, Q, H/4, W/4] f32, ``pred_embds`` [T, Q, C]. The image
        sizes are unused, as in the JAX package: the reference's pixel decoder
        and decoder see no padding."""
        out = self.forward_frames(images)
        return {"pred_logits": out["logits"][-1], "pred_masks": out["masks"][-1],
                "pred_embds": out["embeds"]}


def minvis_match_from_embds(tgt_embds: np.ndarray, cur_embds: np.ndarray,
                            motion_mask: Optional[np.ndarray] = None,
                            current_mask: Optional[np.ndarray] = None) -> np.ndarray:
    """The permutation that aligns the current frame's queries to the previous
    frame's: Hungarian matching of the cosine distance of their embeddings,
    plus half the motion IoU distance when the motion-predicted masks (logits)
    and the current masks are given."""
    from scipy.optimize import linear_sum_assignment

    cur = cur_embds / np.maximum(np.linalg.norm(cur_embds, axis=1, keepdims=True), 1e-12)
    tgt = tgt_embds / np.maximum(np.linalg.norm(tgt_embds, axis=1, keepdims=True), 1e-12)
    cost = 1 - cur @ tgt.T
    if motion_mask is not None and current_mask is not None:
        cm = (current_mask > 0).reshape(len(current_mask), -1).astype(np.float32)
        mm = (1 / (1 + np.exp(-motion_mask)) > 0.5).reshape(len(motion_mask), -1).astype(np.float32)
        inter = cm @ mm.T
        union = cm.sum(1)[:, None] + mm.sum(1)[None] - inter
        iou = (inter + 1e-6) / (union + 1e-6)
        cost = 1.0 * cost + 0.5 * (1 - iou)
    _, indices = linear_sum_assignment(cost.T)
    return indices


def minvis_postprocess(outputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Align every frame's queries to the frame before by embedding matching."""
    logits = np.asarray(outputs["pred_logits"])
    masks = np.asarray(outputs["pred_masks"])
    embds = np.asarray(outputs["pred_embds"])
    out_l, out_m = [logits[0]], [masks[0]]
    prev = embds[0]
    for f in range(1, len(logits)):
        perm = minvis_match_from_embds(prev, embds[f])
        out_l.append(logits[f][perm])
        out_m.append(masks[f][perm])
        prev = embds[f][perm]
    return {"pred_logits": np.stack(out_l), "pred_masks": np.stack(out_m)}


def maskformer_kwargs_from_cfg(cfg) -> dict:
    """MaskFormer constructor arguments from a config node with the JAX
    package's keys (``MODEL.MASK_FORMER.*``, ``MODEL.RESNETS.*``,
    ``MODEL.BACKBONE.NAME``, ``MODEL.SWIN.*``, ``TPU.COMPUTE_DTYPE``,
    ``TPU.MSDA_IMPL``), read by attribute. The decoder's 8 heads are fixed, as
    in the JAX package.

    ``MODEL.RESNETS.STRIDE_IN_1X1`` set raises: the JAX package's
    ``build_maskformer_model`` ignores the key (its ResNet keeps the stride on
    the 3x3), and the port would rather refuse than build another network than
    the file names (ROADMAP Queue 3)."""
    if cfg.MODEL.RESNETS.STRIDE_IN_1X1:
        raise NotImplementedError("MODEL.RESNETS.STRIDE_IN_1X1: the JAX package's MaskFormer builder ignores "
                                  "the key (stride on the 3x3), so the port refuses it (ROADMAP Queue 3)")
    m = cfg.MODEL.MASK_FORMER
    return dict(
        num_classes=m.NUM_CLASSES, hidden_dim=m.HIDDEN_DIM, num_queries=m.NUM_OBJECT_QUERIES,
        dec_layers=m.DEC_LAYERS, enc_layers=m.ENC_LAYERS, dim_feedforward=m.DIM_FEEDFORWARD,
        no_object_weight=m.NO_OBJECT_WEIGHT, deep_supervision=m.DEEP_SUPERVISION,
        num_points=m.TRAIN_NUM_POINTS,
        dtype=torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32,
        msda_impl=cfg.TPU.MSDA_IMPL, **backbone_kwargs_from_cfg(cfg),
    )


def build_maskformer_model(cfg=None, device="cuda", dtype=None, seed: int = 0) -> MaskFormer:
    """MaskFormer in eval mode on ``device`` with seeded random weights.

    The card is the default; with no CUDA device this raises rather than fall
    back to the CPU, which runs the kernels' plain versions only when the
    caller asks for it (``device="cpu"``). Without ``cfg`` the constructor
    defaults apply, which are MinVIS-R50 as ``configs/minvis/ovis_r50.yaml``
    sets it (bf16 compute); ``dtype`` overrides the compute dtype of either.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_maskformer_model: no CUDA device is visible; pass device='cpu' "
                           "to run the plain versions on the CPU")
    kwargs = maskformer_kwargs_from_cfg(cfg) if cfg is not None else {"dtype": torch.bfloat16}
    if dtype is not None:
        kwargs["dtype"] = dtype
    model = MaskFormer(**kwargs)
    init_weights(model, seed)
    return model.to(device).eval()


def maskformer_weight_dict(cfg) -> Dict[str, float]:
    """Loss weights (``MODEL.MASK_FORMER.{CLASS,MASK,DICE}_WEIGHT``); with deep
    supervision the ``_{i}`` keys of the ``DEC_LAYERS`` predictions before the
    last weigh alike."""
    m = cfg.MODEL.MASK_FORMER
    base = {"loss_ce": m.CLASS_WEIGHT, "loss_mask": m.MASK_WEIGHT, "loss_dice": m.DICE_WEIGHT}
    out = dict(base)
    if m.DEEP_SUPERVISION:
        for i in range(m.DEC_LAYERS):
            out.update({f"{k}_{i}": v for k, v in base.items()})
    return out
