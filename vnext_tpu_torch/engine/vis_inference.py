"""IDOL whole-video inference runner.

Counterpart of ``vnext_tpu.engine.vis_inference.IDOLVideoInference``: frames are
resized (shortest edge) and padded to one fixed clip shape, the video runs
through ``IDOL.inference`` in clips of ``batch_infer_len`` frames (the last clip
padded with black frames), and uint8 frames are normalized on the device. With
the host tracker (the default) per-frame candidate selection, NMS and the
streaming tracker run on the host over the small per-query outputs. With
``fused_tracker`` (``TPU.FUSED_TRACKER``) the same selection, a fixed-shape
class-aware NMS and the on-device tracker (``tracking/idol_tracker_device.py``)
run on the clip's outputs where the forward left them, and one copy of the
clip's (query, id) pairs reaches the host after its last frame; capacities of
``fused_dets`` detections a frame and ``fused_capacity`` tracklets
(``TPU.FUSED_TRACKER_DETS`` / ``_CAPACITY``, 64 and 32, as the JAX entry
point passes them) are the only difference, and only where they bind. Masks
are materialized at the video's resolution per output instance.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset_mapper import _load_image
from ..data.transforms import get_resize_shortest_edge
from ..ops.interpolate import resize_bilinear, resize_nearest
from ..ops.nms import batched_nms_mask
from ..structures.boxes import box_cxcywh_to_xyxy as box_cxcywh_to_xyxy_t
from ..tracking.idol_tracker import IDOLTracker, _sigmoid
from ..tracking.idol_tracker_device import init_state, tracker_step


def box_cxcywh_to_xyxy(x: np.ndarray) -> np.ndarray:
    xc, yc, w, h = np.split(x, 4, axis=-1)
    return np.concatenate([xc - 0.5 * w, yc - 0.5 * h, xc + 0.5 * w, yc + 0.5 * h], axis=-1)


def _nms_numpy(boxes: np.ndarray, scores: np.ndarray, idxs: np.ndarray, thr: float) -> np.ndarray:
    """Class-aware greedy NMS (host, small N). Returns kept indices in score
    order, candidates that tie exactly in score in index order, as the fused
    path's stable sort keeps them (the JAX package's unstable ``np.argsort``
    leaves that order to numpy)."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    offs = idxs.astype(np.float64)[:, None] * (boxes.max() + 1)
    b = boxes.astype(np.float64) + offs
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    areas = (b[:, 2] - b[:, 0]).clip(0) * (b[:, 3] - b[:, 1]).clip(0)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        xx1 = np.maximum(b[i, 0], b[order, 0])
        yy1 = np.maximum(b[i, 1], b[order, 1])
        xx2 = np.minimum(b[i, 2], b[order, 2])
        yy2 = np.minimum(b[i, 3], b[order, 3])
        inter = (xx2 - xx1).clip(0) * (yy2 - yy1).clip(0)
        iou = inter / np.maximum(areas[i] + areas[order] - inter, 1e-12)
        suppressed[order[iou > thr]] = True
        suppressed[i] = False
    return np.asarray(keep, np.int64)


def runner_kwargs_from_cfg(cfg) -> dict:
    """Constructor arguments from a config node with the JAX package's keys, as
    ``tools/train_net.py`` wires its own runner for ``--eval-only``."""
    c = cfg.MODEL.IDOL
    return dict(
        test_short_edge=cfg.INPUT.MIN_SIZE_TEST,
        test_max_size=cfg.INPUT.MAX_SIZE_TEST,
        target_size=tuple(cfg.TPU.TEST_IMAGE_SIZE),
        batch_infer_len=c.BATCH_INFER_LEN,
        inference_select_thres=c.INFERENCE_SELECT_THRES,
        nms_pre=c.NMS_PRE,
        add_new_score=c.ADD_NEW_SCORE,
        memory_len=c.MEMORY_LEN,
        inference_fw=c.INFERENCE_FW,
        inference_tw=c.INFERENCE_TW,
        is_multi_cls=c.MULTI_CLS_ON,
        apply_cls_thres=c.APPLY_CLS_THRES,
        temporal_score_type=c.TEMPORAL_SCORE_TYPE,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD),
        fused_tracker=cfg.TPU.FUSED_TRACKER,
        fused_capacity=cfg.TPU.FUSED_TRACKER_CAPACITY,
        fused_dets=cfg.TPU.FUSED_TRACKER_DETS,
    )


class IDOLVideoInference:
    def __init__(
        self,
        model,
        *,
        test_short_edge: int = 480,
        test_max_size: int = 1333,
        target_size: Tuple[int, int] = (480, 864),
        batch_infer_len: int = 10,
        inference_select_thres: float = 0.1,
        nms_pre: float = 0.5,
        add_new_score: float = 0.2,
        memory_len: int = 3,
        inference_fw: bool = True,
        inference_tw: bool = True,
        is_multi_cls: bool = True,
        apply_cls_thres: float = 0.05,
        temporal_score_type: str = "mean",
        pixel_mean: Sequence[float] = (123.675, 116.280, 103.530),
        pixel_std: Sequence[float] = (58.395, 57.120, 57.375),
        image_loader=None,
        fused_tracker: bool = False,
        fused_capacity: int = 32,
        fused_dets: int = 64,
    ):
        self.model = model
        self.device = next(model.parameters()).device
        self.test_short_edge = test_short_edge
        self.test_max_size = test_max_size
        self.target_size = tuple(target_size)
        self.batch_infer_len = batch_infer_len
        self.inference_select_thres = inference_select_thres
        self.nms_pre = nms_pre
        self.add_new_score = add_new_score
        self.memory_len = memory_len
        self.inference_fw = inference_fw
        self.inference_tw = inference_tw
        self.is_multi_cls = is_multi_cls
        self.apply_cls_thres = apply_cls_thres
        self.temporal_score_type = temporal_score_type
        self.pixel_mean = torch.tensor(pixel_mean, dtype=torch.float32, device=self.device)
        self.pixel_std = torch.tensor(pixel_std, dtype=torch.float32, device=self.device)
        self.image_loader = image_loader or _load_image
        self.fused_tracker = fused_tracker
        self.fused_capacity = fused_capacity
        self.fused_dets = fused_dets

    @classmethod
    def from_config(cls, cfg, model, **kwargs) -> "IDOLVideoInference":
        """The runner a config node (``vnext_tpu_torch.config``) describes;
        ``kwargs`` (an ``image_loader``, say) add to or override its values."""
        return cls(model, **{**runner_kwargs_from_cfg(cfg), **kwargs})

    # ------------------------------------------------------------------ frames
    def _prepare_frames(self, record: dict):
        th, tw = self.target_size
        frames, size = [], None
        for path in record["file_names"]:
            img = self.image_loader(path)
            resize = get_resize_shortest_edge(img.shape[0], img.shape[1], self.test_short_edge, self.test_max_size)
            img = resize.apply_image(img)[:th, :tw]
            h, w = img.shape[:2]
            pad = np.zeros((th, tw, 3), np.uint8)
            pad[:h, :w] = img
            frames.append(pad)
            size = (h, w)
        return np.stack(frames), size

    def forward_clip(self, frames: np.ndarray, size: Tuple[int, int]) -> Dict[str, torch.Tensor]:
        """One clip of uint8 frames [T, H, W, 3] -> its f32 outputs on the device."""
        imgs = torch.from_numpy(frames).to(self.device)
        sizes = torch.tensor([size] * len(frames), dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            x = (imgs.float() - self.pixel_mean) / self.pixel_std
            out = self.model.inference(x, sizes)
        return {k: v.float() for k, v in out.items()}

    def infer_clip(self, frames: np.ndarray, size: Tuple[int, int]) -> Dict[str, np.ndarray]:
        """One clip of uint8 frames [T, H, W, 3] -> host f32 outputs."""
        return {k: v.cpu().numpy() for k, v in self.forward_clip(frames, size).items()}

    def _clips(self, frames: np.ndarray):
        """(clip, its count of real frames) in order; the last clip padded to
        the fixed clip length with black frames."""
        t, cl = frames.shape[0], self.batch_infer_len
        for c in range(max(1, math.ceil(t / cl))):
            chunk = frames[c * cl:(c + 1) * cl]
            n = chunk.shape[0]
            if n < cl:
                chunk = np.concatenate([chunk, np.zeros((cl - n, *chunk.shape[1:]), chunk.dtype)])
            yield chunk, n

    def _run_clips(self, frames: np.ndarray, size: Tuple[int, int]) -> Dict[str, np.ndarray]:
        outs: Dict[str, List[np.ndarray]] = {}
        for chunk, n in self._clips(frames):
            for k, v in self.infer_clip(chunk, size).items():
                outs.setdefault(k, []).append(v[:n])
        return {k: np.concatenate(v, axis=0) for k, v in outs.items()}

    def _run_clips_fused(self, frames: np.ndarray, size: Tuple[int, int]):
        """Every clip's host outputs, concatenated, and the per-frame (query,
        track id) pairs of the on-device tracker, run on each clip's outputs
        before they are copied."""
        outs: Dict[str, List[np.ndarray]] = {}

        def clips():
            for chunk, n in self._clips(frames):
                out = self.forward_clip(chunk, size)
                yield out, n
                for k, v in out.items():
                    outs.setdefault(k, []).append(v.cpu().numpy()[:n])

        per_frame = self._track_clips(clips())
        return {k: np.concatenate(v, axis=0) for k, v in outs.items()}, per_frame

    def _track_clips(self, clips) -> List[List[Tuple[int, int]]]:
        """The on-device tracker over (device outputs [T, Q, ...], count of
        real frames) clips in video order, its state carried from clip to clip;
        per-frame [(query, track id), ...]."""
        state, per_frame = None, []
        for out, n in clips:
            if state is None:
                state = self.init_fused_state(out["pred_logits"].shape[1], out["pred_inst_embed"].shape[-1])
            state, pairs = self.track_clip(state, out, n, len(per_frame))
            per_frame += pairs
        return per_frame

    # ------------------------------------------------------------- fused path
    def _tracker_kwargs(self) -> dict:
        return dict(nms_thr_pre=self.nms_pre, nms_thr_post=0.05, init_score_thr=0.2,
                    addnew_score_thr=self.add_new_score, match_score_thr=0.5, memo_tracklet_frames=10,
                    memo_momentum=0.8, match_metric="bisoftmax", long_match=self.inference_tw,
                    frame_weight=(self.inference_tw | self.inference_fw), temporal_weight=self.inference_tw)

    def init_fused_state(self, num_queries: int, embed_dim: int):
        return init_state(self.fused_capacity, min(self.fused_dets, num_queries), embed_dim,
                          memory_len=self.memory_len, device=self.device)

    def track_clip(self, state, outputs: Dict[str, torch.Tensor], n: int, frame0: int):
        """``_track_frames`` and one copy of its pairs to the host: (state,
        per-frame [(query, track id), ...])."""
        state, pairs = self._track_frames(state, outputs, n, frame0)
        if pairs is None:
            return state, []
        return state, [[(int(q), int(i)) for q, i, kp in zip(*frame) if kp and i > -1]
                       for frame in pairs.cpu().numpy()]

    def _track_frames(self, state, outputs: Dict[str, torch.Tensor], n: int, frame0: int):
        """The on-device tracker over the first ``n`` frames of one clip's
        outputs (f32 device tensors [T, Q, ...]): per frame the candidates
        (max class score above ``inference_select_thres``, else the best
        query), class-aware NMS at 0.9, the top ``fused_dets`` by score (ties to
        the lower query) and ``tracker_step``. Returns (state, [n, 3, fused_dets]
        int32 rows of query, id and keep on the device, or None for n = 0);
        nothing is copied to the host."""
        kw = self._tracker_kwargs()
        logits, boxes = outputs["pred_logits"], outputs["pred_boxes"]
        embeds, masks = outputs["pred_inst_embed"], outputs["pred_masks"]
        k = min(self.fused_dets, logits.shape[1])
        per_frame = []
        for t in range(n):
            scores = torch.sigmoid(logits[t])                                # [Q, C]
            mx = scores.amax(-1)
            cls = scores.argmax(-1)
            cand = mx > self.inference_select_thres
            force = torch.arange(len(mx), device=mx.device) == mx.argmax()
            cand = torch.where(cand.any(), cand, force)
            keepn = batched_nms_mask(box_cxcywh_to_xyxy_t(boxes[t]), mx, cls, 0.9, valid=cand)
            s = torch.where(keepn, mx, torch.full_like(mx, -torch.inf))
            top = torch.sort(s, descending=True, stable=True)
            qidx = top.indices[:k]
            det_boxes = torch.cat([boxes[t][qidx], mx[qidx, None]], -1)
            det_masks = torch.sigmoid(masks[t][qidx]) > 0.5
            state, ids, keep = tracker_step(state, det_boxes, cls[qidx], det_masks, embeds[t][qidx],
                                            torch.isfinite(top.values[:k]), frame0 + t, **kw)
            per_frame.append(torch.stack([qidx.to(torch.int32), ids, keep.to(torch.int32)]))
        return state, torch.stack(per_frame) if per_frame else None

    def fused_track_video(self, outputs: Dict[str, np.ndarray]) -> List[List[Tuple[int, int]]]:
        """The on-device tracker over whole-video host outputs, clip by clip
        through the serving path's ``_track_clips``; per-frame [(query, track
        id), ...] as the host association gives them."""
        cl, t = self.batch_infer_len, len(outputs["pred_logits"])
        return self._track_clips(
            ({k: torch.from_numpy(np.asarray(v[c * cl:(c + 1) * cl], np.float32)).to(self.device)
              for k, v in outputs.items()}, min(cl, t - c * cl))
            for c in range(max(1, math.ceil(t / cl))))

    # ------------------------------------------------------------------ video
    def __call__(self, record: dict) -> Dict:
        frames, size = self._prepare_frames(record)
        ori_size = (record["height"], record["width"])
        if self.fused_tracker:
            outputs, per_frame = self._run_clips_fused(frames, size)
            return self._build_video_dict(outputs, per_frame, ori_size, size)
        outputs = self._run_clips(frames, size)
        return self._assemble_video(outputs, self.make_tracker(), ori_size, size)

    def make_tracker(self) -> IDOLTracker:
        """The host tracker with this runner's settings (the reference's inference values)."""
        return IDOLTracker(obj_score_thr=0.1, memory_len=self.memory_len, **self._tracker_kwargs())

    def _assemble_video(self, outputs, tracker, ori_size, image_size) -> Dict:
        return self._build_video_dict(outputs, self.host_track(outputs, tracker), ori_size, image_size)

    def host_track(self, outputs, tracker) -> List[List[Tuple[int, int]]]:
        """Per-frame candidate selection, class-aware NMS and the host tracker's
        association: [(query, track id), ...] a frame."""
        logits, masks = outputs["pred_logits"], outputs["pred_masks"]
        boxes, embeds = outputs["pred_boxes"], outputs["pred_inst_embed"]
        per_frame = []
        for t in range(len(logits)):
            scores_t = _sigmoid(logits[t])
            max_score = scores_t.max(axis=1)
            indices = np.flatnonzero(max_score > self.inference_select_thres)
            if len(indices) == 0:
                indices = np.asarray([int(max_score.argmax())])
            else:
                nms_scores = scores_t[indices].max(axis=1)
                cls_idx = scores_t[indices].argmax(axis=1)
                keep = _nms_numpy(box_cxcywh_to_xyxy(boxes[t][indices]), nms_scores, cls_idx, 0.9)
                indices = indices[keep]
            box_score = scores_t[indices].max(axis=1)
            det_bboxes = np.concatenate([boxes[t][indices], box_score[:, None]], axis=1)
            det_labels = scores_t[indices].argmax(axis=1)
            _, _, ids, kept_indices = tracker.match(
                det_bboxes, det_labels, masks[t][indices], embeds[t][indices], t, list(indices))
            per_frame.append([(q, int(i)) for q, i in zip(kept_indices, ids) if i > -1])
        return per_frame

    def _build_video_dict(self, outputs, per_frame, ori_size, image_size) -> Dict:
        """Mask/score assembly from per-frame (query, track-id) pairs."""
        logits, masks = outputs["pred_logits"], outputs["pred_masks"]
        video_dict: Dict[int, Dict] = {}
        for t, kept in enumerate(per_frame):
            scores_t = _sigmoid(logits[t])
            for q, tid in kept:
                entry = video_dict.setdefault(
                    tid, {"masks": [None] * t, "scores": [None] * t, "valid": 0})
                entry["masks"].append(masks[t][q])
                entry["scores"].append(scores_t[q])
                entry["valid"] += 1
            for entry in video_dict.values():
                while len(entry["masks"]) < t + 1:
                    entry["masks"].append(None)
                    entry["scores"].append(None)
            if t > 8:  # prune short noisy tracks
                for tid in [k for k, v in video_dict.items()
                            if v["masks"][-1] is None and v["masks"][-2] is None and v["valid"] < 3]:
                    video_dict.pop(tid)

        logits_list, masks_list = [], []
        for entry in video_dict.values():
            logit = np.stack([s for s in entry["scores"] if s is not None])
            logits_list.append(logit.mean(0) if self.temporal_score_type == "mean" else logit.max(0))
            masks_list.append(entry["masks"])

        out_scores, out_labels, out_masks = [], [], []
        if logits_list:
            pred_cls = np.stack(logits_list)
            if self.is_multi_cls:
                above = np.nonzero(pred_cls > self.apply_cls_thres)
                out_scores = pred_cls[above].tolist()
                out_labels = above[1].tolist()
                out_masks = [masks_list[i] for i in above[0]]
            else:
                out_scores = pred_cls.max(-1).tolist()
                out_labels = pred_cls.argmax(-1).tolist()
                out_masks = masks_list
        return {
            "image_size": ori_size,
            "pred_scores": out_scores,
            "pred_labels": out_labels,
            "pred_masks": [[self._finalize_mask(m, image_size, ori_size) for m in inst]
                           for inst in out_masks],
        }

    @staticmethod
    def _finalize_mask(mask_logit_s4: Optional[np.ndarray], image_size, ori_size) -> Optional[np.ndarray]:
        """stride-4 logits -> bool mask at the video's resolution: x4 bilinear
        upsample, sigmoid, crop the padding, nearest resize, > 0.5."""
        if mask_logit_s4 is None:
            return None
        h4, w4 = mask_logit_s4.shape
        up = resize_bilinear(torch.from_numpy(np.asarray(mask_logit_s4, np.float32))[None],
                             h4 * 4, w4 * 4)[0]
        prob = (1.0 / (1.0 + torch.exp(-up)))[: image_size[0], : image_size[1]]
        if tuple(prob.shape) != tuple(ori_size):
            prob = resize_nearest(prob[None], ori_size[0], ori_size[1])[0]
        return prob.numpy() > 0.5
