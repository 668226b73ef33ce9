"""SeqFormer whole-video and clip-matched inference.

Counterpart of ``vnext_tpu.engine.seqformer_inference``: ``SeqFormer.inference``
decodes a whole video as one clip, or, with clip matching, overlapping windows
of ``clip_length`` frames (``clip_stride * clip_length`` apart, the last flush
with the end) whose top queries ``VideoStitcher`` links by spatio-temporal mask
IoU. Each window keeps its 10 queries of highest class probability: they are
picked on the card and only their masks are copied to the host (all 300 would
be ~620 MB of f32 for a 20-frame video). Multi-class thresholding and the
full-resolution masks are the IDOL runner's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .vis_inference import IDOLVideoInference
from ..tracking.idol_tracker import _sigmoid


def topk_queries(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` queries of highest class probability, [Q, C] logits -> [k]
    indices, best first: the JAX runner's ``np.argsort(-sigmoid(logits).max(1))[:k]``.
    The sigmoid is monotone, so the logits sort alike; ties go to the lower
    query index (a stable sort)."""
    return torch.sort(-logits.float().max(1).values, stable=True).indices[:k]


class VideoStitcher:
    """Merge overlapping clip predictions by spatio-temporal IoU (the reference's
    ``Videos``): numpy and ``scipy.optimize.linear_sum_assignment`` on the host."""

    def __init__(self, video_length: int, num_classes: int, mask_size: Tuple[int, int],
                 max_inst: int = 120, match_threshold: float = 0.01):
        self.video_length = video_length
        self.match_threshold = match_threshold
        self.max_inst = max_inst
        self.num_inst = 0
        self.num_clip = 0
        self.saved_idx = set()
        h, w = mask_size
        self.logits = np.zeros((0, video_length, h, w), np.float32)   # [N, T, H, W]
        self.valid = np.zeros((0, video_length), bool)
        self.cls = np.zeros((0, num_classes), np.float32)
        self.contrib = np.zeros((0,), np.int32)                       # clips per instance

    def update(self, frame_idx: List[int], cls_probs: np.ndarray, mask_logits: np.ndarray) -> None:
        """cls_probs [N, C]; mask_logits [N, T_clip, H, W] for the frames ``frame_idx``."""
        from scipy.optimize import linear_sum_assignment

        probs = _sigmoid(mask_logits)
        overlap = [i for i, f in enumerate(frame_idx) if f in self.saved_idx]
        matched_rows: Dict[int, int] = {}
        if overlap and self.num_inst:
            ov_frames = [frame_idx[i] for i in overlap]
            i_masks = probs[:, overlap].reshape(len(probs), -1)
            s_masks = _sigmoid(self.logits[:, ov_frames]).reshape(self.num_inst, -1)
            s_valid = np.repeat(
                self.valid[:, ov_frames], probs.shape[-1] * probs.shape[-2], axis=1
            ).astype(np.float32)
            inter = (s_masks[:, None] * i_masks[None]) * s_valid[:, None]
            union = ((s_masks[:, None] + i_masks[None] - s_masks[:, None] * i_masks[None])
                     * s_valid[:, None])
            siou = inter.sum(-1) / (union.sum(-1) + 1e-6)                # [N_s, N_i]
            gated = siou * (siou > self.match_threshold)
            rows, cols = linear_sum_assignment(gated, maximize=True)
            for r, c in zip(rows, cols):
                if siou[r, c] > self.match_threshold:
                    matched_rows[c] = r

        for c in range(len(probs)):
            if c in matched_rows:
                r = matched_rows[c]
            else:
                if self.num_inst >= self.max_inst:
                    continue
                r = self.num_inst
                self.num_inst += 1
                self.logits = np.concatenate(
                    [self.logits, np.zeros((1, *self.logits.shape[1:]), np.float32)])
                self.valid = np.concatenate([self.valid, np.zeros((1, self.video_length), bool)])
                self.cls = np.concatenate([self.cls, np.zeros((1, self.cls.shape[1]), np.float32)])
                self.contrib = np.concatenate([self.contrib, np.zeros((1,), np.int32)])
            # average the logits where clips overlap
            for ti, f in enumerate(frame_idx):
                if self.valid[r, f]:
                    self.logits[r, f] = (self.logits[r, f] + mask_logits[c, ti]) / 2
                else:
                    self.logits[r, f] = mask_logits[c, ti]
                    self.valid[r, f] = True
            self.cls[r] = (self.cls[r] * self.contrib[r] + cls_probs[c]) / (self.contrib[r] + 1)
            self.contrib[r] += 1

        self.saved_idx.update(frame_idx)
        self.num_clip += 1

    def get_result(self):
        return self.cls, self.logits, self.valid


def seqformer_runner_kwargs_from_cfg(cfg) -> dict:
    """Constructor arguments from a config node with the JAX package's keys, as
    ``demo/demo.py`` wires the SeqFormer runner."""
    c = cfg.MODEL.SeqFormer
    return dict(
        clip_matching=c.CLIP_MATCHING,
        clip_length=c.CLIP_LENGTH,
        clip_stride=c.CLIP_STRIDE,
        test_short_edge=cfg.INPUT.MIN_SIZE_TEST,
        test_max_size=cfg.INPUT.MAX_SIZE_TEST,
        target_size=tuple(cfg.TPU.TEST_IMAGE_SIZE),
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD),
    )


class SeqFormerVideoInference(IDOLVideoInference):
    """Whole-video (or clip-matched) SeqFormer inference on the IDOL runner's
    frame preparation and mask finalization."""

    def __init__(self, model, *, clip_matching: bool = False, clip_length: int = 5,
                 clip_stride: int = 1, topk: int = 10, **kwargs):
        kwargs.setdefault("batch_infer_len", clip_length)
        super().__init__(model, **kwargs)
        self.clip_matching = clip_matching
        self.clip_length = clip_length
        self.clip_stride = clip_stride
        self.topk = topk

    @classmethod
    def from_config(cls, cfg, model) -> "SeqFormerVideoInference":
        return cls(model, **seqformer_runner_kwargs_from_cfg(cfg))

    def infer_topk(self, frames: np.ndarray, size: Tuple[int, int]):
        """One clip of uint8 frames [T, H, W, 3] through ``SeqFormer.inference``:
        (class probabilities [k, C], mask logits [k, T, H/4, W/4]) of its top-k
        queries as host f32, picked on the card."""
        imgs = torch.from_numpy(frames).to(self.device)
        sizes = torch.tensor([size], dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            x = (imgs.float() - self.pixel_mean) / self.pixel_std
            out = self.model.inference(x[None], sizes)
            order = topk_queries(out["pred_logits"], self.topk)
            masks = out["pred_masks"][order].float().cpu().numpy()
        logits = out["pred_logits"].float().cpu().numpy()
        return _sigmoid(logits[order.cpu().numpy()]), masks

    def __call__(self, record: dict) -> Dict:
        frames, size = self._prepare_frames(record)
        t = frames.shape[0]
        ori_size = (record["height"], record["width"])

        if not self.clip_matching or t <= self.clip_length:
            cls, masks = self.infer_topk(frames, size)
            valid = np.ones((len(cls), t), bool)
        else:
            stitcher = None
            start = 0
            while True:
                is_last = start + self.clip_length >= t
                s = max(0, t - self.clip_length) if is_last else start
                frame_idx = list(range(s, s + self.clip_length))
                cls_k, masks_k = self.infer_topk(frames[frame_idx], size)
                if stitcher is None:
                    stitcher = VideoStitcher(t, cls_k.shape[1], masks_k.shape[-2:])
                stitcher.update(frame_idx, cls_k, masks_k)
                if is_last:
                    break
                start += self.clip_stride * self.clip_length
            cls, masks, valid = stitcher.get_result()

        # multi-class thresholding and full-resolution masks
        out_scores, out_labels, out_masks = [], [], []
        for inst, label in zip(*np.nonzero(cls > self.apply_cls_thres)):
            out_scores.append(float(cls[inst, label]))
            out_labels.append(int(label))
            out_masks.append([
                None if not valid[inst].all() and not valid[inst, f]
                else self._finalize_mask(masks[inst, f], size, ori_size)
                for f in range(t)
            ])
        return {
            "image_size": ori_size,
            "pred_scores": out_scores,
            "pred_labels": out_labels,
            "pred_masks": out_masks,
        }
