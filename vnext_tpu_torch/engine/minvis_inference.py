"""MinVIS (+ InstMove motion) whole-video inference runner.

Counterpart of ``vnext_tpu.engine.minvis_inference.MinVISVideoInference``: the
frames are prepared as the IDOL runner prepares them, run through
``MaskFormer.inference`` in windows of ``window_size`` frames (the last one
padded with black frames), and every frame's queries are aligned to the frame
before by matching their embeddings (``minvis_match_from_embds``). With a motion
predictor, from frame ``motion_history`` on, its IoU cost against the masks it
predicts from the previous aligned masks and the current frame joins the
embedding cost. Then the video keeps the ``topk`` (query, class) pairs by mean
softmax score, each with its mask on every frame at the video's resolution.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.mask2former import minvis_match_from_embds
from ..tracking.idol_tracker import _sigmoid
from .vis_inference import IDOLVideoInference


class MinVISVideoInference(IDOLVideoInference):
    """``model`` is a ``MaskFormer``; ``motion_predictor`` an ``InstMovePredictor``
    or None. Other keyword arguments are the IDOL runner's, but its clip length:
    the clips are the windows of ``window_size`` frames."""

    def __init__(self, model, *, window_size: int = 3, topk: int = 10, motion_predictor=None,
                 motion_history: int = 4, **kwargs):
        super().__init__(model, batch_infer_len=window_size, **kwargs)
        self.window_size = window_size
        self.topk = topk
        self.motion_predictor = motion_predictor
        self.motion_history = motion_history

    def predict_motion(self, history: np.ndarray, frame: np.ndarray) -> np.ndarray:
        """Mask logits [Q, H/4, W/4] the predictor expects on ``frame`` (uint8 [H,
        W, 3]) from the previous aligned mask logits ``history`` [Q, T, H/4, W/4].
        The frame goes to the card once and is broadcast to the Q queries there."""
        mp = self.motion_predictor
        dt = next(mp.parameters()).device
        hist = torch.from_numpy(_sigmoid(history).astype(np.float32)).to(dt)[..., None]
        with torch.inference_mode():
            img = (torch.from_numpy(frame).to(dt).float() - self.pixel_mean.to(dt)) / self.pixel_std.to(dt)
            img = img[None].expand(hist.shape[0], *img.shape)
            return mp(hist, img)[:, 0, ..., 0].float().cpu().numpy()

    def __call__(self, record: dict) -> Dict:
        frames, size = self._prepare_frames(record)
        out = self._run_clips(frames, size)
        logits, masks, embds = out["pred_logits"], out["pred_masks"], out["pred_embds"]
        t = len(logits)

        # align queries across frames (embedding cost; + motion cost when available)
        aligned_l, aligned_m = [logits[0]], [masks[0]]
        prev_embd = embds[0]
        for f in range(1, t):
            motion_mask = None
            if self.motion_predictor is not None and f >= self.motion_history:
                motion_mask = self.predict_motion(
                    np.stack(aligned_m[f - self.motion_history:f], axis=1), frames[f])
            perm = minvis_match_from_embds(
                prev_embd, embds[f], motion_mask=motion_mask,
                current_mask=masks[f] if motion_mask is not None else None)
            aligned_l.append(logits[f][perm])
            aligned_m.append(masks[f][perm])
            prev_embd = embds[f][perm]
        logits = np.stack(aligned_l)   # [T, Q, C+1]
        masks = np.stack(aligned_m)    # [T, Q, H4, W4]

        # video-level selection: mean softmax scores over the frames, then top-k
        probs = np.exp(logits - logits.max(-1, keepdims=True))
        probs = probs / probs.sum(-1, keepdims=True)
        cls_mean = probs.mean(0)[:, :-1]          # [Q, C]
        flat = cls_mean.reshape(-1)
        k = min(self.topk, flat.size)
        top_idx = np.argsort(-flat)[:k]
        q_idx = top_idx // cls_mean.shape[1]
        labels = top_idx % cls_mean.shape[1]
        scores = flat[top_idx]

        ori_size = (record["height"], record["width"])
        return {
            "image_size": ori_size,
            "pred_scores": scores.tolist(),
            "pred_labels": labels.tolist(),
            "pred_masks": [[self._finalize_mask(masks[f, q], size, ori_size) for f in range(t)]
                           for q in q_idx],
        }
