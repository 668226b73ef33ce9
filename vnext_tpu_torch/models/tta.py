"""Test-time augmentation for detectors.

Counterpart of ``vnext_tpu.models.tta`` (reference surface:
detectron2/modeling/test_time_augmentation.py:307 GeneralizedRCNNWithTTA):
inference over each shorter-side size in ``min_sizes`` and, with ``flip``,
its horizontal flip, the detections mapped back to the original frame and
merged by class-aware NMS; ``GeneralizedRCNNWithTTA`` then runs the mask
branch alone on the merged boxes in every variant and averages the masks,
flipping back those of the flipped variants.

Each variant is resized bilinearly (``ops/interpolate.resize_bilinear``, the
JAX package's matrices) and not padded, so its sides may be odd: the ResNet
stem pads an odd side itself. Nothing here reads ``TEST.AUG.ENABLED``: as in
the JAX package, neither entry point wraps its model (ROADMAP Queue 3, item 5).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from ..ops.interpolate import resize_bilinear
from ..ops.nms import batched_nms_mask


def _resized(images: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    return resize_bilinear(images.permute(0, 3, 1, 2), nh, nw).permute(0, 2, 3, 1).contiguous()


def _flipped(images: torch.Tensor) -> torch.Tensor:
    return images.flip(2).contiguous()


class DetectorWithTTA:
    def __init__(self, infer_fn: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                 min_sizes: Sequence[int] = (400, 500, 600), flip: bool = True, nms_thresh: float = 0.5,
                 max_detections: int = 100):
        """infer_fn: images [B, H, W, 3] -> {boxes [B, N, 4], scores, classes, valid}."""
        self._infer = infer_fn
        self.min_sizes = list(min_sizes)
        self.flip = flip
        self.nms_thresh = nms_thresh
        self.max_detections = max_detections

    def _sizes(self, h: int, w: int):
        for short in self.min_sizes:
            scale = short / min(h, w)
            yield int(round(h * scale)), int(round(w * scale))

    def _augmented_batches(self, images: torch.Tensor):
        """Yields (augmented images, the map of their boxes back to the original frame)."""
        _, h, w, _ = images.shape
        for nh, nw in self._sizes(h, w):
            resized = _resized(images, nh, nw)
            sx, sy = w / nw, h / nh
            scale = torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=images.device)
            yield resized, lambda boxes, scale=scale: boxes * scale
            if self.flip:
                def unmap_flip(boxes, sx=sx, sy=sy, nw=nw):
                    return torch.stack([(nw - boxes[..., 2]) * sx, boxes[..., 1] * sy, (nw - boxes[..., 0]) * sx,
                                        boxes[..., 3] * sy], -1)

                yield _flipped(resized), unmap_flip

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        parts = {"boxes": [], "scores": [], "classes": [], "valid": []}
        for aug, unmap in self._augmented_batches(images):
            out = self._infer(aug)
            parts["boxes"].append(unmap(out["boxes"]))
            for k in ("scores", "classes", "valid"):
                parts[k].append(out[k])
        boxes, scores, classes, valid = (torch.cat(parts[k], 1) for k in ("boxes", "scores", "classes", "valid"))
        outs = []
        for bx, sc, cl, va in zip(boxes, scores, classes, valid):
            keep = batched_nms_mask(bx, sc, cl, self.nms_thresh, valid=va)
            s = torch.where(keep, sc, torch.full_like(sc, -1.0))
            outv, outi = torch.sort(s, descending=True, stable=True)       # lax.top_k's order
            outv, outi = outv[:self.max_detections], outi[:self.max_detections]
            outs.append((bx[outi], outv, cl[outi], outv > 0))
        return dict(zip(("boxes", "scores", "classes", "valid"), (torch.stack(t) for t in zip(*outs))))


class GeneralizedRCNNWithTTA(DetectorWithTTA):
    """Full R-CNN TTA (reference test_time_augmentation.py:101) over the port's
    ``GeneralizedRCNN`` (its own weights; the JAX package passes ``params``):

    1. detect in every size / flip variant, map the boxes back to the original
       frame, and merge the union by class-aware NMS (inherited);
    2. map the merged boxes into each variant, run the mask branch alone there
       (``inference_masks_on_boxes``), flip the flipped variants' masks back and
       average them into ``mask_probs``.

    ``image_sizes`` [B, 2] gives the batch size of the per-variant sizes."""

    def __init__(self, model, image_sizes: torch.Tensor, **kwargs):
        self.model = model
        self.image_sizes = image_sizes

        def infer(images):
            return model.inference(images, self._scaled_sizes(images.shape[1:3], images.device))

        super().__init__(infer, **kwargs)

    def _scaled_sizes(self, hw, device) -> torch.Tensor:
        return torch.tensor([[hw[0], hw[1]]], dtype=torch.int32, device=device).repeat(self.image_sizes.shape[0], 1)

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        merged = super().__call__(images)
        if not getattr(self.model, "mask_on", False):
            return merged
        boxes, classes = merged["boxes"], merged["classes"]
        mask_sum, count = None, 0
        for aug, remap, flipped in self._augmented_with_remap(images):
            probs = self.model.inference_masks_on_boxes(aug, remap(boxes), classes)
            if flipped:
                probs = probs.flip(-1)
            mask_sum = probs if mask_sum is None else mask_sum + probs
            count += 1
        merged["mask_probs"] = mask_sum / count
        return merged

    def _augmented_with_remap(self, images: torch.Tensor):
        """Yields (augmented images, the map of original-frame boxes into them,
        whether they are flipped)."""
        _, h, w, _ = images.shape
        for nh, nw in self._sizes(h, w):
            resized = _resized(images, nh, nw)
            fx, fy = nw / w, nh / h
            scale = torch.tensor([fx, fy, fx, fy], dtype=torch.float32, device=images.device)
            yield resized, lambda boxes, scale=scale: boxes * scale, False
            if self.flip:
                def remap_flip(boxes, fx=fx, fy=fy, nw=nw):
                    return torch.stack([nw - boxes[..., 2] * fx, boxes[..., 1] * fy, nw - boxes[..., 0] * fx,
                                        boxes[..., 3] * fy], -1)

                yield _flipped(resized), remap_flip, True
