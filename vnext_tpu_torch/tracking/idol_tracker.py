"""IDOL streaming tracker: memory-bank embedding association, on the host.

The JAX package's host tracker (``vnext_tpu.tracking.idol_tracker``) carried over
as it is: it is numpy, and per-frame work is tens of tracks. It cannot be
imported from there because that package's ``__init__`` imports jax. Mask-NMS
pre-filter, bisoftmax embedding similarity, frame- and temporally-weighted
long-term embeddings, EMA memory update with velocity, backdrops and tracklet
expiry.

Inputs per frame: det boxes [N, 5] (cxcywh + score), labels [N], mask logits
[N, H, W], embeddings [N, C].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def mask_iou_matrix(masks1: np.ndarray, masks2: np.ndarray, eps=1e-6) -> np.ndarray:
    m1 = masks1.reshape(len(masks1), -1).astype(np.float32)
    m2 = masks2.reshape(len(masks2), -1).astype(np.float32)
    inter = m1 @ m2.T
    union = m1.sum(1)[:, None] + m2.sum(1)[None, :] - inter
    return (inter + eps) / (union + eps)


def mask_nms_keep(mask_logits: np.ndarray, thr: float) -> np.ndarray:
    """Sequential mask NMS in input order (reference tracker.py:26)."""
    n = len(mask_logits)
    keep = np.ones(n, bool)
    if n == 0:
        return keep
    bin_masks = _sigmoid(mask_logits) > 0.5
    iou = mask_iou_matrix(bin_masks, bin_masks)
    for i in range(n - 1):
        if not keep[i]:
            continue
        for j in range(i + 1, n):
            if keep[j] and iou[i, j] > thr:
                keep[j] = False
    return keep


@dataclass
class _Tracklet:
    bbox: np.ndarray
    embed: np.ndarray
    long_embed: List[np.ndarray]
    long_score: List[float]
    label: int
    last_frame: int
    velocity: np.ndarray
    acc_frame: int = 0
    exist_frame: int = 1


class IDOLTracker:
    def __init__(
        self,
        # class defaults mirror the reference exactly (idol/models/tracker.py:52-70);
        # the IDOL inference path overrides them with the trained-config values
        # (idol/idol.py:278-290 == engine/vis_inference.py tracker construction)
        nms_thr_pre: float = 0.7,
        nms_thr_post: float = 0.3,
        init_score_thr: float = 0.2,
        addnew_score_thr: float = 0.5,
        obj_score_thr: float = 0.1,
        match_score_thr: float = 0.5,
        memo_tracklet_frames: int = 10,
        memo_backdrop_frames: int = 1,
        memo_momentum: float = 0.5,
        match_metric: str = "bisoftmax",
        long_match: bool = False,
        frame_weight: bool = False,
        temporal_weight: bool = False,
        memory_len: int = 10,
    ):
        assert 0 <= memo_momentum <= 1.0
        assert match_metric in ("bisoftmax", "softmax", "cosine")
        self.nms_thr_pre = nms_thr_pre
        self.nms_thr_post = nms_thr_post
        self.init_score_thr = init_score_thr
        self.addnew_score_thr = addnew_score_thr
        self.obj_score_thr = obj_score_thr
        self.match_score_thr = match_score_thr
        self.memo_tracklet_frames = memo_tracklet_frames
        self.memo_backdrop_frames = memo_backdrop_frames
        self.memo_momentum = memo_momentum
        self.match_metric = match_metric
        self.long_match = long_match
        self.frame_weight = frame_weight
        self.temporal_weight = temporal_weight
        self.memory_len = memory_len

        self.num_tracklets = 0
        self.tracklets: Dict[int, _Tracklet] = {}
        self.backdrops: List[dict] = []

    @property
    def empty(self) -> bool:
        return not self.tracklets

    # -------------------------------------------------------------- memory
    def _memo(self):
        ids, bboxes, embeds, labels, exist = [], [], [], [], []
        for tid, t in self.tracklets.items():
            ids.append(tid)
            bboxes.append(t.bbox)
            labels.append(t.label)
            exist.append(t.exist_frame)
            if self.long_match:
                weights = np.asarray(t.long_score, np.float32)
                if self.temporal_weight:
                    length = len(weights)
                    weights = weights + np.arange(1, length + 1, dtype=np.float32) / length
                stack = np.stack(t.long_embed)
                embeds.append((stack * weights[:, None]).sum(0) / weights.sum())
            else:
                embeds.append(t.embed)
        return (
            np.asarray(ids, np.int64),
            np.stack(bboxes),
            np.stack(embeds),
            np.asarray(labels, np.int64),
            np.asarray(exist, np.float32),
        )

    def _update_memo(self, ids, bboxes, embeds, labels, frame_id):
        for i in np.flatnonzero(ids > -1):
            tid = int(ids[i])
            if tid in self.tracklets:
                t = self.tracklets[tid]
                velocity = (bboxes[i] - t.bbox) / max(frame_id - t.last_frame, 1)
                t.velocity = (t.velocity * t.acc_frame + velocity) / (t.acc_frame + 1)
                t.acc_frame += 1
                t.exist_frame += 1
                t.bbox = bboxes[i]
                t.embed = (1 - self.memo_momentum) * t.embed + self.memo_momentum * embeds[i]
                t.long_embed.append(embeds[i])
                t.long_score.append(float(bboxes[i][-1]))
                t.last_frame = frame_id
                t.label = int(labels[i])
            else:
                self.tracklets[tid] = _Tracklet(
                    bbox=bboxes[i],
                    embed=embeds[i],
                    long_embed=[embeds[i]],
                    long_score=[float(bboxes[i][-1])],
                    label=int(labels[i]),
                    last_frame=frame_id,
                    velocity=np.zeros_like(bboxes[i]),
                )

        backdrop_idx = np.flatnonzero(ids == -1)
        self.backdrops.insert(
            0,
            {"bboxes": bboxes[backdrop_idx], "embeds": embeds[backdrop_idx],
             "labels": labels[backdrop_idx]},
        )

        for tid in [k for k, t in self.tracklets.items()
                    if frame_id - t.last_frame >= self.memo_tracklet_frames]:
            self.tracklets.pop(tid)
        for t in self.tracklets.values():
            if len(t.long_embed) > self.memory_len:
                t.long_embed.pop(0)
            if len(t.long_score) > self.memory_len:
                t.long_score.pop(0)
        if len(self.backdrops) > self.memo_backdrop_frames:
            self.backdrops.pop()

    # -------------------------------------------------------------- matching
    def match(
        self,
        bboxes: np.ndarray,       # [N, 5] cxcywh + score
        labels: np.ndarray,       # [N]
        masks: np.ndarray,        # [N, H, W] mask logits
        track_feats: np.ndarray,  # [N, C]
        frame_id: int,
        indices: List[int],
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[int]]:
        # mask NMS pre-filter (keeps input order)
        keep = mask_nms_keep(masks, self.nms_thr_pre)
        indices = [ind for ind, k in zip(indices, keep) if k]
        bboxes = bboxes[keep]
        labels = labels[keep]
        masks = masks[keep]
        embeds = track_feats[keep]

        n = len(bboxes)
        ids = np.full(n, -2, np.int64)

        if n > 0 and not self.empty:
            memo_ids, memo_bboxes, memo_embeds, memo_labels, memo_exist = self._memo()
            feats = embeds @ memo_embeds.T
            if self.match_metric == "bisoftmax":
                d2t = _softmax(feats, axis=1)
                t2d = _softmax(feats, axis=0)
                scores = (d2t + t2d) / 2
            elif self.match_metric == "softmax":
                scores = _softmax(feats, axis=1)
            else:
                e = embeds / np.maximum(np.linalg.norm(embeds, axis=1, keepdims=True), 1e-12)
                m = memo_embeds / np.maximum(np.linalg.norm(memo_embeds, axis=1, keepdims=True), 1e-12)
                scores = e @ m.T

            for i in range(n):
                row = scores[i]
                if self.frame_weight:
                    non_backs = (memo_ids > -1) & (row > 0.5)
                    if non_backs.sum() > 1:
                        weighted = row.copy()
                        fw = memo_exist[non_backs]
                        weighted[non_backs] = weighted[non_backs] * fw
                        weighted[~non_backs] = weighted[~non_backs] * fw.mean()
                        # reference takes max over *weighted* scores and compares that
                        # same weighted value against the threshold (tracker.py:247-254)
                        memo_ind = int(np.argmax(weighted))
                        conf = weighted[memo_ind]
                    else:
                        memo_ind = int(np.argmax(row))
                        conf = row[memo_ind]
                else:
                    memo_ind = int(np.argmax(row))
                    conf = row[memo_ind]
                if conf > self.match_score_thr:
                    tid = int(memo_ids[memo_ind])
                    if tid > -1:
                        ids[i] = tid
                        scores[:i, memo_ind] = 0
                        scores[i + 1 :, memo_ind] = 0

            new_mask = (ids == -2) & (bboxes[:, 4] > self.addnew_score_thr)
            num_news = int(new_mask.sum())
            ids[new_mask] = np.arange(self.num_tracklets, self.num_tracklets + num_news)
            self.num_tracklets += num_news

            self._assign_backdrops(ids, masks)
            self._update_memo(ids, bboxes, embeds, labels, frame_id)

        elif self.empty:
            init_mask = (ids == -2) & (bboxes[:, 4] > self.init_score_thr)
            num_news = int(init_mask.sum())
            ids[init_mask] = np.arange(self.num_tracklets, self.num_tracklets + num_news)
            self.num_tracklets += num_news
            self._assign_backdrops(ids, masks)
            self._update_memo(ids, bboxes, embeds, labels, frame_id)

        return bboxes, labels, ids, indices

    def _assign_backdrops(self, ids: np.ndarray, masks: np.ndarray) -> None:
        """Unassigned dets that overlap nothing earlier become backdrops (id -1)."""
        unsel = np.flatnonzero(ids == -2)
        if len(unsel) == 0:
            return
        bin_all = _sigmoid(masks) > 0.5
        ious = mask_iou_matrix(bin_all[unsel], bin_all)
        for i, ind in enumerate(unsel):
            if (ious[i, :ind] < self.nms_thr_post).all():
                ids[ind] = -1


def _softmax(x: np.ndarray, axis: int) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)
