"""The set criterion of IDOL: fixed-shape losses over padded slots.

Counterpart of ``vnext_tpu.models.criterion`` (``Targets``, ``loss_labels``,
``loss_boxes``, ``loss_masks``, ``loss_reid``, ``default_weight_dict``): focal
classification over all queries, L1 + GIoU on matched pairs, focal + dice masks
on the matched-instance slots and the contrastive ReID loss, each a masked
reduction over fixed shapes.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from ..ops.losses import dice_loss, sigmoid_focal_loss, sigmoid_focal_loss_elementwise
from ..structures.boxes import box_cxcywh_to_xyxy, elementwise_giou_loss
from ..parallel.mesh import global_count
from .matcher import MatchResult


class Targets(NamedTuple):
    """Padded per-frame ground truth; K is the fixed instance capacity."""

    labels: torch.Tensor     # [B, K] int class ids (padding arbitrary)
    boxes: torch.Tensor      # [B, K, 4] normalized cxcywh
    masks_s4: torch.Tensor   # [B, K, H/4, W/4] bool, sampled at the mask output stride
    valid: torch.Tensor      # [B, K] bool
    inst_id: torch.Tensor    # [B, K] int track ids (-1 = absent)


def _num(mask: torch.Tensor) -> torch.Tensor:
    """The count of ``mask`` over the global batch, this rank's share of it
    under a process group (``parallel.global_count``)."""
    return global_count(mask.sum())


def loss_labels(logits, match: MatchResult, targets: Targets, num_classes: int) -> torch.Tensor:
    """Focal classification loss (alpha 0.25, gamma 2) over all queries, summed
    and divided by the number of matched queries."""
    gt_cls = torch.gather(targets.labels.long(), 1, match.gt_index)           # [B, Q]
    target_classes = torch.where(match.selected_query, gt_cls, num_classes)
    onehot = F.one_hot(target_classes, num_classes + 1)[..., :-1].float()
    loss = sigmoid_focal_loss_elementwise(logits.float(), onehot)
    return loss.sum() / _num(match.selected_query)


def loss_boxes(boxes, match: MatchResult, targets: Targets) -> Dict[str, torch.Tensor]:
    """L1 and GIoU on the matched (query, gt) pairs."""
    gt_boxes = torch.gather(targets.boxes.float(), 1, match.gt_index[..., None].expand(-1, -1, 4))
    sel = match.selected_query.float()
    num = global_count(sel.sum())
    boxes = boxes.float()
    l1 = (boxes - gt_boxes).abs().sum(-1)
    giou = elementwise_giou_loss(box_cxcywh_to_xyxy(boxes), box_cxcywh_to_xyxy(gt_boxes))
    return {"loss_bbox": (l1 * sel).sum() / num, "loss_giou": (giou * sel).sum() / num}


def loss_masks(mask_logits, inst_gt_index, inst_valid, targets: Targets) -> Dict[str, torch.Tensor]:
    """Focal and dice mask losses on the matched-instance slots.
    mask_logits [B, N, H4, W4]; inst_gt_index [B, N] gt slot of each; inst_valid [B, N]."""
    b, n = inst_gt_index.shape
    h4, w4 = targets.masks_s4.shape[-2:]
    idx = inst_gt_index[..., None, None].expand(-1, -1, h4, w4)
    gt = torch.gather(targets.masks_s4.to(mask_logits.dtype), 1, idx)
    num = _num(inst_valid)
    flat_logits = mask_logits.reshape(b * n, -1).float()
    flat_gt = gt.reshape(b * n, -1).float()
    flat_valid = inst_valid.reshape(b * n)
    return {
        "loss_mask": sigmoid_focal_loss(flat_logits, flat_gt, num, valid=flat_valid),
        "loss_dice": dice_loss(flat_logits, flat_gt, num, valid=flat_valid),
    }


def _masked_logsumexp(x, mask):
    return torch.logsumexp(x.masked_fill(~mask, float("-inf")), -1)


def loss_reid(key_embeds, ref_embeds, matched_query_per_gt, pos_mask, neg_mask,
              item_valid) -> Dict[str, torch.Tensor]:
    """Contrastive ReID loss.

    Per (frame, gt): s = <ref_embed_q, key_embed_matched>; the objective
    log(1 + sum_{i in pos, j in neg} e^{s_j - s_i}) is softplus(LSE_neg(s) +
    LSE_pos(-s)). The auxiliary cosine loss takes the expectation of the
    reference's uniform sampling of min(10 |pos|, |neg|) negatives. key_embeds /
    ref_embeds [B, Q, C]; matched_query_per_gt [B, K]; pos / neg [B, K, Q];
    item_valid [B, K] (the gt is in both frames)."""
    c = key_embeds.shape[-1]
    key_sel = torch.gather(key_embeds, 1, matched_query_per_gt[..., None].expand(-1, -1, c))
    scores = torch.einsum("bqc,bkc->bkq", ref_embeds.float(), key_sel.float())

    has_pos = pos_mask.any(-1)
    contras = F.softplus(_masked_logsumexp(scores, neg_mask) + _masked_logsumexp(-scores, pos_mask))
    contras = torch.where(has_pos & item_valid, contras, 0.0)

    key_n = key_sel / torch.linalg.vector_norm(key_sel, dim=-1, keepdim=True).clamp_min(1e-12)
    ref_n = ref_embeds / torch.linalg.vector_norm(ref_embeds, dim=-1, keepdim=True).clamp_min(1e-12)
    cos = torch.einsum("bqc,bkc->bkq", ref_n.float(), key_n.float())
    n_pos = pos_mask.sum(-1).float()
    n_neg = neg_mask.sum(-1).float().clamp_min(1.0)
    n_samp = torch.where(n_pos > 0, torch.minimum(10.0 * n_pos, n_neg), 10.0)
    pos_term = torch.where(pos_mask, (cos - 1.0) ** 2, 0.0).sum(-1)
    neg_term = n_samp * torch.where(neg_mask, cos ** 2, 0.0).sum(-1) / n_neg
    aux = (pos_term + neg_term) / (n_pos + n_samp).clamp_min(1.0)
    aux = torch.where(item_valid, aux, 0.0)

    num_items = _num(item_valid)
    return {"loss_reid": contras.sum() / num_items, "loss_reid_aux": aux.sum() / num_items}


def default_weight_dict(class_weight: float = 2.0, l1_weight: float = 5.0, giou_weight: float = 2.0,
                        mask_weight: float = 2.0, dice_weight: float = 5.0, reid_weight: float = 2.0,
                        dec_layers: int = 6, deep_supervision: bool = True) -> Dict[str, float]:
    """Loss weights of the IDOL recipe (``MODEL.IDOL.*_WEIGHT``; by default class
    2, L1 5, GIoU 2, ReID 2 and its cosine term 1.5x that, mask 2, dice 5); with
    deep supervision, ``_i`` keys weigh decoder layer i < last alike."""
    w = {"loss_ce": class_weight, "loss_bbox": l1_weight, "loss_giou": giou_weight,
         "loss_reid": reid_weight, "loss_reid_aux": reid_weight * 1.5, "loss_mask": mask_weight,
         "loss_dice": dice_weight}
    if deep_supervision:
        base = dict(w)
        for i in range(dec_layers - 1):
            w.update({f"{k}_{i}": v for k, v in base.items()})
    return w
