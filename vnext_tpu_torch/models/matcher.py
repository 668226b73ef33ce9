"""simOTA dynamic-k matching on the device, batched over the frames.

Counterpart of ``vnext_tpu.models.matcher`` (``get_in_boxes_info``,
``build_match_cost``, ``dynamic_k_matching``, ``match``, ``pos_neg_masks``). The
JAX package vmaps one image's fixed-shape matching over the batch; here every
function carries the batch dimension itself, and nothing loops over instances
on the host or waits for the device.

Conventions: B frames, Q queries, K padded ground-truth slots; ``gt_valid``
marks the real ones. Boxes are normalized cxcywh. Where the JAX package picks
among ties (``lax.top_k``, ``argmin``, ``argmax``) it takes the lowest index;
so do the stable sort and ``argmin`` / ``argmax`` here, so the two match the
same pairs.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..structures.boxes import box_cxcywh_to_xyxy, generalized_box_iou, pairwise_iou

_BIG = 1e5
_INF = 1e9


class MatchResult(NamedTuple):
    selected_query: torch.Tensor        # [B, Q] bool: the query is matched to some gt
    gt_index: torch.Tensor              # [B, Q] int64: its gt slot (0 if unselected)
    matched_query_per_gt: torch.Tensor  # [B, K] int64: the min-cost matched query of each gt
    matching_matrix: torch.Tensor       # [B, Q, K] float 0/1


def get_in_boxes_info(boxes_cxcywh, gt_cxcywh, expanded_strides: int = 32,
                      center_radius: float = 2.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query centres inside gt boxes or near gt centres. boxes [B, Q, 4], gt
    [B, K, 4]; returns ([B, Q] bool, [B, Q, K] bool)."""
    gt_xyxy = box_cxcywh_to_xyxy(gt_cxcywh)[:, None]                  # [B, 1, K, 4]
    cx = boxes_cxcywh[..., 0:1]                                       # [B, Q, 1]
    cy = boxes_cxcywh[..., 1:2]
    in_box = ((cx > gt_xyxy[..., 0]) & (cx < gt_xyxy[..., 2])
              & (cy > gt_xyxy[..., 1]) & (cy < gt_xyxy[..., 3]))
    r = center_radius / expanded_strides
    gcx = gt_cxcywh[:, None, :, 0]
    gcy = gt_cxcywh[:, None, :, 1]
    in_center = (cx > gcx - r) & (cx < gcx + r) & (cy > gcy - r) & (cy < gcy + r)
    return in_box.any(2) | in_center.any(2), in_box & in_center


def focal_class_cost(prob, gt_labels, alpha: float = 0.25, gamma: float = 2.0):
    """[B, Q, K] focal-aware classification cost; prob [B, Q, C], gt_labels [B, K]."""
    neg = (1 - alpha) * prob ** gamma * (-torch.log(1 - prob + 1e-8))
    pos = alpha * (1 - prob) ** gamma * (-torch.log(prob + 1e-8))
    idx = gt_labels.long()[:, None, :].expand(-1, prob.shape[1], -1)
    return torch.gather(pos, 2, idx) - torch.gather(neg, 2, idx)


def build_match_cost(prob, boxes, gt_labels, gt_boxes, gt_valid):
    """Returns (cost [B, Q, K] with invalid gts at 1e9, ious [B, Q, K])."""
    fg_mask, in_box_center = get_in_boxes_info(boxes, gt_boxes)
    boxes_xyxy, gt_xyxy = box_cxcywh_to_xyxy(boxes), box_cxcywh_to_xyxy(gt_boxes)
    valid = gt_valid[:, None, :]
    ious = torch.where(valid, pairwise_iou(boxes_xyxy, gt_xyxy), 0.0)
    cost = (focal_class_cost(prob, gt_labels)
            + 3.0 * (-generalized_box_iou(boxes_xyxy, gt_xyxy))
            + 100.0 * (~in_box_center))
    cost = cost + 10000.0 * (~fg_mask)[..., None]
    return torch.where(valid, cost, _INF), ious


def dynamic_k_matching(cost, ious, gt_valid, n_candidate_k: int = 10) -> torch.Tensor:
    """[B, Q, K] 0/1 matching matrix: dynamic-k OTA with conflict repair.

    Each gt takes its dynamic_k cheapest queries, dynamic_k = clamp(sum of its
    top-n IoUs, 1, n); a query claimed by several gts keeps its cheapest one; then
    K repair passes let each unmatched gt claim its cheapest unmatched query. The
    passes run K times whatever the data, as the JAX package's ``fori_loop``
    does: a pass after the last unmatched gt is gone changes nothing, and
    counting them would wait for the device."""
    b, q, k = cost.shape
    n_cand = min(n_candidate_k, q)
    cost_t = cost.transpose(1, 2)                                      # [B, K, Q]
    topk_ious = torch.topk(ious.transpose(1, 2), n_cand, dim=-1).values
    dynamic_ks = topk_ious.sum(-1).to(torch.int32).clamp(1, n_cand)    # [B, K]
    cand_idx = torch.argsort(cost_t, dim=-1, stable=True)[..., :n_cand]  # ascending cost
    rank_ok = (torch.arange(n_cand, device=cost.device) < dynamic_ks[..., None]) & gt_valid[..., None]
    mm = torch.zeros_like(cost_t).scatter_(2, cand_idx, rank_ok.to(cost.dtype)).transpose(1, 2)

    best_gt = F.one_hot(cost.argmin(2), k).to(cost.dtype)             # invalid gts never win

    def resolve_conflicts(mm):
        return torch.where((mm.sum(2) > 1)[..., None], best_gt, mm)

    mm = resolve_conflicts(mm)
    for _ in range(k):
        matched_q = (mm.sum(2) > 0).to(cost.dtype)
        unmatched_col = (mm.sum(1) == 0) & gt_valid                    # [B, K]
        pick = (cost + _BIG * matched_q[..., None]).argmin(1)          # [B, K]
        claim = F.one_hot(pick, q).to(cost.dtype).transpose(1, 2)       # [B, Q, K]
        mm = torch.where(unmatched_col[:, None, :], torch.maximum(mm, claim), mm)
        mm = resolve_conflicts(mm)
    return mm


def match(pred_logits, pred_boxes, gt_labels, gt_boxes, gt_valid) -> MatchResult:
    """pred_logits [B, Q, C], pred_boxes [B, Q, 4]; gt_labels [B, K], gt_boxes
    [B, K, 4], gt_valid [B, K] bool."""
    prob = torch.sigmoid(pred_logits.float())
    cost, ious = build_match_cost(prob, pred_boxes.float(), gt_labels, gt_boxes.float(), gt_valid)
    mm = dynamic_k_matching(cost, ious, gt_valid, n_candidate_k=10)
    selected = mm.sum(2) > 0
    gt_index = mm.argmax(2)
    matched_query_per_gt = torch.where(mm > 0, cost, _INF).argmin(1)
    return MatchResult(selected, gt_index, matched_query_per_gt, mm)


def pos_neg_masks(ref_prob, ref_boxes, gt_labels, gt_boxes, gt_valid):
    """Contrastive query sets per gt on the reference frame, [B, K, Q] each:
    pos[k, q] when q is in the dynamic-k(10) match of gt k, neg[k, q] when it
    is not in the dynamic-k(100) match."""
    cost, ious = build_match_cost(ref_prob, ref_boxes, gt_labels, gt_boxes, gt_valid)
    mm_pos = dynamic_k_matching(cost, ious, gt_valid, n_candidate_k=10)
    mm_neg = dynamic_k_matching(cost, ious, gt_valid, n_candidate_k=100)
    return mm_pos.transpose(1, 2) > 0, ~(mm_neg.transpose(1, 2) > 0)
