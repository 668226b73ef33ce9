"""On-device IDOL tracker: fixed capacity, fixed shapes, no copy to the host.

Counterpart of ``vnext_tpu.tracking.idol_tracker_device``: the association of
the host tracker (``tracking/idol_tracker.py``: mask-NMS pre-filter, bisoftmax
embedding similarity, frame-weighted greedy assignment, temporally weighted
long-term memory, EMA embedding update, backdrops and tracklet expiry) over a
state of fixed-shape device tensors, so that a clip's frames run on the card
one after another and only the clip's (query, id) pairs come back to the host.
The JAX package's ``fori_loop``s (the mask NMS and the greedy assignment)
become Python loops over device tensors: every branch is a ``where`` on the
device, and nothing in a step reads a value back (``torch.cuda``'s sync debug
mode, set to raise, holds this on the card).

Capacity: K tracklet slots, Nd detections a frame, M long-memory entries, Bd
backdrop slots (Nd x ``memo_backdrop_frames``). Births beyond the free slots
are dropped; the host tracker is unbounded. Ties follow the JAX package:
``argmax`` takes the first maximum.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from ..ops.nms import greedy_keep

NEG = -1e30


class TrackerState(NamedTuple):
    """Fixed-capacity tracker memory: every leaf a device tensor of fixed shape."""

    slot_tid: torch.Tensor      # [K] int32, -1 = free slot
    bbox: torch.Tensor          # [K, 5] cxcywh + score
    embed: torch.Tensor         # [K, C] EMA embedding
    long_embed: torch.Tensor    # [K, M, C] shift register of recent embeddings, newest last
    long_score: torch.Tensor    # [K, M]
    long_count: torch.Tensor    # [K] int32 valid entries of long_*
    label: torch.Tensor         # [K] int32
    last_frame: torch.Tensor    # [K] int32
    exist_frame: torch.Tensor   # [K] int32
    acc_frame: torch.Tensor     # [K] int32
    velocity: torch.Tensor      # [K, 5]
    bd_embed: torch.Tensor      # [Bd, C] backdrop embeddings
    bd_valid: torch.Tensor      # [Bd] bool
    num_tracklets: torch.Tensor  # [] int32, the next fresh track id


def init_state(capacity: int, num_dets: int, embed_dim: int, memory_len: int = 3,
               memo_backdrop_frames: int = 1, device="cpu") -> TrackerState:
    k, c, m = capacity, embed_dim, memory_len
    bd = num_dets * memo_backdrop_frames
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return TrackerState(
        slot_tid=torch.full((k,), -1, **i32),
        bbox=torch.zeros(k, 5, **f32),
        embed=torch.zeros(k, c, **f32),
        long_embed=torch.zeros(k, m, c, **f32),
        long_score=torch.zeros(k, m, **f32),
        long_count=torch.zeros(k, **i32),
        label=torch.zeros(k, **i32),
        last_frame=torch.zeros(k, **i32),
        exist_frame=torch.zeros(k, **i32),
        acc_frame=torch.zeros(k, **i32),
        velocity=torch.zeros(k, 5, **f32),
        bd_embed=torch.zeros(bd, c, **f32),
        bd_valid=torch.zeros(bd, dtype=torch.bool, device=device),
        num_tracklets=torch.zeros((), **i32),
    )


def _mask_iou(m1: torch.Tensor, m2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    a = m1.reshape(m1.shape[0], -1).float()
    b = m2.reshape(m2.shape[0], -1).float()
    inter = a @ b.T
    union = a.sum(1)[:, None] + b.sum(1)[None, :] - inter
    return (inter + eps) / (union + eps)


def _mask_nms_keep(bin_masks: torch.Tensor, det_valid: torch.Tensor, thr: float) -> torch.Tensor:
    """Sequential mask NMS in input order (the host tracker's ``mask_nms_keep``)."""
    keep = greedy_keep(_mask_iou(bin_masks, bin_masks) > thr, det_valid)
    return keep & det_valid


def _masked_softmax(x: torch.Tensor, valid: torch.Tensor, dim: int) -> torch.Tensor:
    x = torch.where(valid, x, torch.full_like(x, NEG))
    x = x - x.amax(dim, keepdim=True)
    e = torch.exp(x) * valid
    return e / e.sum(dim, keepdim=True).clamp_min(1e-30)


def _take(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """x[index] for a 0-d index tensor, as a 0-d tensor (no copy to the host)."""
    return x.gather(0, index.view(1))[0]


def tracker_step(
    state: TrackerState,
    bboxes: torch.Tensor,       # [Nd, 5] cxcywh + score
    labels: torch.Tensor,       # [Nd] int
    bin_masks: torch.Tensor,    # [Nd, H, W] bool (sigmoid(logits) > 0.5)
    embeds: torch.Tensor,       # [Nd, C]
    det_valid: torch.Tensor,    # [Nd] bool, the padding mask of the fixed Nd
    frame_id: Union[int, torch.Tensor],
    *,
    nms_thr_pre: float = 0.7,
    nms_thr_post: float = 0.3,
    init_score_thr: float = 0.2,
    addnew_score_thr: float = 0.5,
    match_score_thr: float = 0.5,
    memo_tracklet_frames: int = 10,
    memo_momentum: float = 0.5,
    match_metric: str = "bisoftmax",
    long_match: bool = False,
    frame_weight: bool = False,
    temporal_weight: bool = False,
) -> Tuple[TrackerState, torch.Tensor, torch.Tensor]:
    """One tracker frame (the defaults are the host tracker's). Returns
    (new state, ids [Nd] int32, keep [Nd] bool): id -2 unassigned or dropped,
    -1 backdrop, >= 0 a track id; only meaningful where keep is True."""
    dev = bboxes.device
    k_slots, m = state.slot_tid.shape[0], state.long_score.shape[1]
    nd = bboxes.shape[0]
    i32 = torch.int32

    keep = _mask_nms_keep(bin_masks, det_valid, nms_thr_pre)
    embeds = embeds.float()
    track_valid = state.slot_tid >= 0
    has_tracks = track_valid.any()

    # ------------------------------------------------ memo embeddings
    if long_match:
        cnt = state.long_count
        pos = torch.arange(m, device=dev)[None, :]
        entry_valid = pos < cnt[:, None]
        w = state.long_score
        if temporal_weight:
            # chronological rank 1..len over the valid (newest-last) prefix
            w = w + (pos + 1).float() / cnt[:, None].clamp_min(1).float()
        w = w * entry_valid
        memo_embeds = (state.long_embed * w[..., None]).sum(1) / w.sum(1, keepdim=True).clamp_min(1e-30)
    else:
        memo_embeds = state.embed
    # the rows are the K tracklet slots; the backdrop queue only suppresses births
    memo_valid = track_valid
    memo_ids = torch.where(track_valid, state.slot_tid, torch.full_like(state.slot_tid, -1))
    memo_exist = state.exist_frame.float()

    feats = embeds @ memo_embeds.T                                          # [Nd, K]
    if match_metric == "bisoftmax":
        scores = (_masked_softmax(feats, memo_valid[None, :], 1) + _masked_softmax(feats, keep[:, None], 0)) / 2
    elif match_metric == "softmax":
        scores = _masked_softmax(feats, memo_valid[None, :], 1)
    else:  # cosine
        e = embeds / embeds.norm(dim=1, keepdim=True).clamp_min(1e-12)
        mm = memo_embeds / memo_embeds.norm(dim=1, keepdim=True).clamp_min(1e-12)
        scores = e @ mm.T
    scores = scores * memo_valid[None, :]

    # ------------------------------------------------ greedy assignment, detection by detection
    ids = torch.full((nd,), -2, dtype=i32, device=dev)
    cols = torch.arange(k_slots, device=dev)
    rows = torch.arange(nd, device=dev)
    neg = torch.full((k_slots,), NEG, device=dev)
    for i in range(nd):
        row = scores[i]
        if frame_weight:
            non_backs = (memo_ids > -1) & (row > 0.5)
            nb = non_backs.sum()
            fw_mean = torch.where(nb > 0, (memo_exist * non_backs).sum() / nb.clamp_min(1), 0.0)
            weighted = torch.where(non_backs, row * memo_exist, row * fw_mean)
            use_w = nb > 1
            memo_ind = torch.where(use_w, torch.where(memo_valid, weighted, neg).argmax(),
                                   torch.where(memo_valid, row, neg).argmax())
            conf = torch.where(use_w, _take(weighted, memo_ind), _take(row, memo_ind))
        else:
            memo_ind = torch.where(memo_valid, row, neg).argmax()
            conf = _take(row, memo_ind)
        tid = _take(memo_ids, memo_ind)
        take = keep[i] & has_tracks & (conf > match_score_thr) & (tid > -1)
        ids[i] = torch.where(take, tid, ids[i])
        # the matched column is zeroed for every other detection
        clear = take & (rows != i)[:, None] & (cols == memo_ind)[None, :]
        scores = scores * (~clear)

    # ------------------------------------------------ births
    birth_thr = torch.where(has_tracks, addnew_score_thr, init_score_thr)
    new_mask = keep & (ids == -2) & (bboxes[:, 4] > birth_thr)
    new_rank = (torch.cumsum(new_mask.to(i32), 0) - 1).to(i32)
    ids = torch.where(new_mask, state.num_tracklets + new_rank, ids)
    num_tracklets = (state.num_tracklets + new_mask.sum()).to(i32)

    # ------------------------------------------------ backdrops
    # unassigned detections overlapping nothing earlier in input order become id -1
    unsel = keep & (ids == -2)
    iou_all = _mask_iou(bin_masks, bin_masks) * keep[None, :] * keep[:, None]
    earlier = rows[None, :] < rows[:, None]
    clear = (torch.where(earlier, iou_all, 0.0) < nms_thr_post).all(1)
    ids = torch.where(unsel & clear, -1, ids)

    # ------------------------------------------------ memory update
    assigned = keep & (ids > -1)
    # slot lookup: an existing id -> its slot; a new one -> a free slot by birth rank
    slot_of_tid = torch.where(
        assigned[:, None] & (state.slot_tid[None, :] == ids[:, None]) & track_valid[None, :], cols[None, :], k_slots)
    exist_slot = slot_of_tid.amin(1)                                       # [Nd], K = not found
    is_new = assigned & (exist_slot == k_slots)
    free_sorted = torch.sort(torch.where(~track_valid, cols, k_slots)).values   # free slots ascending
    new_rank2 = torch.cumsum(is_new.long(), 0) - 1
    slot = torch.where(is_new, free_sorted[new_rank2.clamp(0, k_slots - 1)], exist_slot)
    write = assigned & (slot < k_slots)
    onehot = ((slot.clamp(0, k_slots - 1)[:, None] == cols[None, :]) & write[:, None]).float()   # [Nd, K]
    upd = onehot.sum(0) > 0                                                # [K] updated this frame
    det_of_slot = onehot.argmax(0)       # at most one detection a slot; the first where none

    d_bbox = bboxes[det_of_slot].float()
    d_embed = embeds[det_of_slot]
    d_label = labels[det_of_slot].to(i32)
    d_score = d_bbox[:, 4]
    d_new = is_new[det_of_slot]

    dt = (frame_id - state.last_frame).clamp_min(1).float()
    vel = (d_bbox - state.bbox) / dt[:, None]
    accf = state.acc_frame.float()
    upd_old = upd & ~d_new
    velocity = torch.where(upd_old[:, None], (state.velocity * accf[:, None] + vel) / (accf[:, None] + 1),
                           torch.where(upd[:, None], 0.0, state.velocity))
    acc_frame = torch.where(upd_old, state.acc_frame + 1, torch.where(upd, 0, state.acc_frame)).to(i32)
    exist_frame = torch.where(upd_old, state.exist_frame + 1, torch.where(upd, 1, state.exist_frame)).to(i32)
    bbox = torch.where(upd[:, None], d_bbox, state.bbox)
    embed = torch.where(upd_old[:, None], (1 - memo_momentum) * state.embed + memo_momentum * d_embed,
                        torch.where(upd[:, None], d_embed, state.embed))

    # long memory: a shift-register append (newest last), reset at birth
    shift = upd & (state.long_count >= m) & ~d_new
    long_embed = torch.where(shift[:, None, None], torch.roll(state.long_embed, -1, 1), state.long_embed)
    long_score = torch.where(shift[:, None], torch.roll(state.long_score, -1, 1), state.long_score)
    long_count0 = torch.where(d_new & upd, 0, state.long_count)
    wpos = torch.where(shift, m - 1, long_count0).clamp(0, m - 1)
    pos_onehot = ((wpos[:, None] == torch.arange(m, device=dev)[None, :]) & upd[:, None]).float()   # [K, M]
    long_embed = long_embed * (1 - pos_onehot[..., None]) + pos_onehot[..., None] * d_embed[:, None, :]
    long_score = long_score * (1 - pos_onehot) + pos_onehot * d_score[:, None]
    long_count = torch.where(upd, (torch.where(d_new, 0, state.long_count) + 1).clamp_max(m),
                             state.long_count).to(i32)

    label = torch.where(upd, d_label, state.label)
    last_frame = torch.where(upd, frame_id, state.last_frame).to(i32)
    slot_tid = torch.where(upd, ids[det_of_slot], state.slot_tid)

    # expiry
    expired = (slot_tid >= 0) & (frame_id - last_frame >= memo_tracklet_frames)
    slot_tid = torch.where(expired, -1, slot_tid).to(i32)

    # the backdrop queue (memo_backdrop_frames frames of Nd slots, newest first)
    bd_new_valid = keep & (ids == -1)
    if state.bd_embed.shape[0] == nd:
        bd_embed, bd_valid = embeds, bd_new_valid
    else:
        bd_embed = torch.cat([embeds, state.bd_embed[:-nd]], 0)
        bd_valid = torch.cat([bd_new_valid, state.bd_valid[:-nd]], 0)

    new_state = TrackerState(
        slot_tid=slot_tid, bbox=bbox, embed=embed, long_embed=long_embed, long_score=long_score,
        long_count=long_count, label=label, last_frame=last_frame, exist_frame=exist_frame,
        acc_frame=acc_frame, velocity=velocity, bd_embed=bd_embed, bd_valid=bd_valid,
        num_tracklets=num_tracklets)
    return new_state, ids, keep
