"""Drawing utilities for detection/VIS outputs.

Capability parity with detectron2/utils/visualizer.py (Visualizer: boxes, masks,
labels) and video_visualizer.py (VideoVisualizer: cross-frame color-consistent
instance drawing) — implemented on PIL (no cv2/matplotlib dependency).

The port's own copy of ``vnext_tpu.utils.visualizer``: numpy and PIL, so both
packages draw the same pixels.
"""

from __future__ import annotations

import colorsys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

Color = Tuple[int, int, int]


class ColorMode:
    """Reference visualizer.py ColorMode: IMAGE draws on the raw image,
    SEGMENTATION prefers per-class colors, IMAGE_BW grays out unmasked areas."""

    IMAGE = 0
    SEGMENTATION = 1
    IMAGE_BW = 2


def _color_for(idx: int) -> Color:
    """Deterministic, well-spread color palette."""
    h = (idx * 0.6180339887) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.75, 0.95)
    return int(r * 255), int(g * 255), int(b * 255)


def _jitter(color: Color, seed: int = 0) -> Color:
    """Small random color perturbation (reference visualizer.py _jitter) so
    same-class instances stay distinguishable in SEGMENTATION mode."""
    rng = np.random.RandomState(seed)
    vec = rng.rand(3) - 0.5
    vec = vec / np.linalg.norm(vec) * 0.5 * 255
    return tuple(int(np.clip(c + v, 0, 255)) for c, v in zip(color, vec))


def _brightness(color: Color) -> float:
    return (0.299 * color[0] + 0.587 * color[1] + 0.114 * color[2]) / 255.0


def _change_brightness(color: Color, factor: float) -> Color:
    """reference visualizer.py _change_color_brightness: shift lightness by
    ``factor`` (negative = darker) in HLS space."""
    h, l, s = colorsys.rgb_to_hls(*(c / 255.0 for c in color))
    l = min(max(l + factor * l, 0.0), 1.0)
    r, g, b = colorsys.hls_to_rgb(h, l, s)
    return int(r * 255), int(g * 255), int(b * 255)


def _mask_boundary(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels of a binary mask (1-px erosion difference)."""
    m = np.asarray(mask, bool)
    interior = m.copy()
    interior[1:] &= m[:-1]
    interior[:-1] &= m[1:]
    interior[:, 1:] &= m[:, :-1]
    interior[:, :-1] &= m[:, 1:]
    return m & ~interior


def rotated_box_corners(box5: Sequence[float]) -> np.ndarray:
    """(cx, cy, w, h, angle_deg ccw) -> [4, 2] corner points (reference
    visualizer.py draw_rotated_box_with_label geometry)."""
    cx, cy, w, h, a = [float(v) for v in box5]
    theta = np.deg2rad(-a)  # image y-axis points down
    c, s = np.cos(theta), np.sin(theta)
    rel = np.asarray(
        [[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]]
    )
    rot = rel @ np.asarray([[c, -s], [s, c]]).T
    return rot + np.asarray([cx, cy])


class Visualizer:
    """Draw instances on a single RGB image (HWC uint8)."""

    def __init__(self, img_rgb: np.ndarray, class_names: Optional[Sequence[str]] = None,
                 mask_alpha: float = 0.45, color_mode: int = ColorMode.IMAGE):
        self._img = Image.fromarray(np.asarray(img_rgb, np.uint8)).convert("RGB")
        self._names = list(class_names) if class_names else None
        self._alpha = mask_alpha
        self._mode = color_mode

    def _text(self, draw: ImageDraw.ImageDraw, xy, text: str, color: Color):
        """Label with a brightness-adaptive foreground on a dark backdrop
        (reference draw_text: black outline + lightness-adjusted fill)."""
        fg = _change_brightness(color, 0.7 if _brightness(color) < 0.5 else 0.3)
        x, y = xy
        tw = max(6 * len(text), 1)
        draw.rectangle([x, y, x + tw, y + 11], fill=(0, 0, 0))
        draw.text((x + 1, y), text, fill=fg)

    def draw_instances(
        self,
        boxes: Optional[np.ndarray] = None,     # [N, 4] xyxy (abs pixels)
        labels: Optional[np.ndarray] = None,    # [N] int
        scores: Optional[np.ndarray] = None,    # [N] float
        masks: Optional[np.ndarray] = None,     # [N, H, W] bool
        colors: Optional[List[Color]] = None,
        track_ids: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        n = 0
        for x in (boxes, labels, scores, masks):
            if x is not None:
                n = len(x)
                break
        if colors is None:
            ids = track_ids if track_ids is not None else range(n)
            if self._mode == ColorMode.SEGMENTATION and labels is not None:
                # per-class base color, jittered per instance (reference
                # SEGMENTATION mode semantics)
                colors = [
                    _jitter(_color_for(int(labels[i])), seed=int(i))
                    for i in range(n)
                ]
            else:
                colors = [_color_for(int(i)) for i in ids]

        base = np.asarray(self._img, np.float32)
        if self._mode == ColorMode.IMAGE_BW and masks is not None:
            # gray out everything outside the union of masks (reference
            # _create_grayscale_image)
            gray = base @ np.asarray([0.299, 0.587, 0.114])
            union = np.zeros(base.shape[:2], bool)
            for i in range(n):
                m = np.asarray(masks[i], bool)
                if m.shape == base.shape[:2]:
                    union |= m
            base = np.where(union[..., None], base, gray[..., None])
        if masks is not None:
            for i in range(n):
                m = np.asarray(masks[i], bool)
                if m.shape != base.shape[:2]:
                    continue
                c = np.asarray(colors[i], np.float32)
                base[m] = base[m] * (1 - self._alpha) + c * self._alpha
                # boundary outline in a darker shade (reference draws polygon
                # edges at alpha=1)
                edge = _mask_boundary(m)
                base[edge] = np.asarray(_change_brightness(tuple(colors[i]), -0.5))
        out = Image.fromarray(base.astype(np.uint8))
        draw = ImageDraw.Draw(out)
        for i in range(n):
            c = tuple(colors[i])
            if boxes is not None:
                x1, y1, x2, y2 = [float(v) for v in boxes[i]]
                draw.rectangle([x1, y1, x2, y2], outline=c, width=2)
                tx, ty = x1, max(y1 - 12, 0)
            elif masks is not None:
                ys, xs = np.nonzero(masks[i])
                if len(ys) == 0:
                    continue
                tx, ty = float(xs.min()), max(float(ys.min()) - 12, 0)
            else:
                continue
            text = ""
            if labels is not None:
                li = int(labels[i])
                text = self._names[li] if self._names and li < len(self._names) else str(li)
            if scores is not None:
                text += f" {float(scores[i]):.0%}"
            if track_ids is not None:
                text = f"#{int(track_ids[i])} " + text
            if text:
                self._text(draw, (tx, ty), text.strip(), c)
        self._img = out
        return np.asarray(out)

    def draw_rotated_instances(
        self,
        boxes5: np.ndarray,                     # [N, 5] (cx, cy, w, h, angle)
        labels: Optional[np.ndarray] = None,
        scores: Optional[np.ndarray] = None,
        colors: Optional[List[Color]] = None,
    ) -> np.ndarray:
        """Rotated-box drawing (reference draw_rotated_box_with_label)."""
        draw = ImageDraw.Draw(self._img)
        for i in range(len(boxes5)):
            c = tuple(colors[i]) if colors else _color_for(i)
            pts = rotated_box_corners(boxes5[i])
            draw.polygon([tuple(p) for p in pts], outline=c)
            text = ""
            if labels is not None:
                li = int(labels[i])
                text = self._names[li] if self._names and li < len(self._names) else str(li)
            if scores is not None:
                text += f" {float(scores[i]):.0%}"
            if text:
                self._text(draw, tuple(pts.min(0)), text.strip(), c)
        return np.asarray(self._img)

    def draw_sem_seg(
        self,
        sem_seg: np.ndarray,                    # [H, W] class ids
        stuff_names: Optional[Sequence[str]] = None,
        ignore_value: int = 255,
    ) -> np.ndarray:
        """Per-class overlay + a label at each class's centroid (reference
        visualizer.py draw_sem_seg)."""
        base = np.asarray(self._img, np.float32)
        labels = []
        for cls in np.unique(sem_seg):
            if cls == ignore_value:
                continue
            m = sem_seg == cls
            c = np.asarray(_color_for(int(cls)), np.float32)
            base[m] = base[m] * (1 - self._alpha) + c * self._alpha
            ys, xs = np.nonzero(m)
            name = (
                stuff_names[int(cls)]
                if stuff_names and int(cls) < len(stuff_names)
                else str(int(cls))
            )
            labels.append((float(xs.mean()), float(ys.mean()), name,
                           tuple(int(v) for v in c)))
        out = Image.fromarray(base.astype(np.uint8))
        draw = ImageDraw.Draw(out)
        for x, y, name, c in labels:
            self._text(draw, (x, y), name, c)
        self._img = out
        return np.asarray(out)

    def draw_dataset_dict(self, record: dict) -> np.ndarray:
        """Draw ground-truth annotations of one dataset dict (reference
        visualizer.py draw_dataset_dict): boxes (any BoxMode), polygon/RLE
        segmentations, keypoints."""
        from ..structures.boxes import BoxMode

        annos = record.get("annotations", [])
        boxes, labels, masks, kps = [], [], None, []
        h = record.get("height", np.asarray(self._img).shape[0])
        w = record.get("width", np.asarray(self._img).shape[1])
        mask_list = []
        for a in annos:
            bm = a.get("bbox_mode", 0)
            boxes.append(BoxMode.convert(np.asarray(a["bbox"], np.float64)[None], bm, 0)[0])
            labels.append(a.get("category_id", 0))
            segm = a.get("segmentation")
            if segm is not None:
                from ..structures.masks import polygons_to_bitmask

                if isinstance(segm, dict):
                    from ..evaluation.rle import rle_decode

                    mask_list.append(rle_decode(segm))
                else:
                    mask_list.append(
                        polygons_to_bitmask([np.asarray(p) for p in segm], h, w)
                    )
            if a.get("keypoints"):
                kps.append(np.asarray(a["keypoints"], np.float64).reshape(-1, 3))
        if mask_list and len(mask_list) == len(boxes):
            masks = np.stack(mask_list)
        out = self.draw_instances(
            boxes=np.asarray(boxes) if boxes else None,
            labels=np.asarray(labels) if labels else None,
            masks=masks,
        )
        if kps:
            out = self.draw_keypoints(np.stack(kps))
        if "sem_seg" in record:
            out = self.draw_sem_seg(np.asarray(record["sem_seg"]))
        return out

    def draw_keypoints(
        self,
        keypoints: np.ndarray,                  # [N, K, 3] (x, y, vis/score)
        connectivity: Optional[Sequence[Tuple[int, int]]] = None,
        radius: int = 3,
        vis_thresh: float = 0.05,
    ) -> np.ndarray:
        """Dots per visible keypoint + optional skeleton edges (reference
        visualizer.py draw_and_connect_keypoints)."""
        draw = ImageDraw.Draw(self._img)
        kp = np.asarray(keypoints, np.float64)
        for i in range(kp.shape[0]):
            c = _color_for(i)
            for k in range(kp.shape[1]):
                x, y, v = kp[i, k]
                if v <= vis_thresh:
                    continue
                draw.ellipse([x - radius, y - radius, x + radius, y + radius], fill=c)
            if connectivity:
                for a, b in connectivity:
                    if kp[i, a, 2] > vis_thresh and kp[i, b, 2] > vis_thresh:
                        draw.line([tuple(kp[i, a, :2]), tuple(kp[i, b, :2])],
                                  fill=c, width=2)
        return np.asarray(self._img)

    def draw_panoptic_seg(
        self,
        panoptic: np.ndarray,                   # [H, W] segment ids (0 = void)
        segments_info: Sequence[dict],
        stuff_names: Optional[Sequence[str]] = None,
    ) -> np.ndarray:
        """Overlay every panoptic segment with a stable per-id color (reference
        visualizer.py draw_panoptic_seg)."""
        base = np.asarray(self._img, np.float32)
        draw_labels = []
        for seg in segments_info:
            m = panoptic == seg["id"]
            if not m.any():
                continue
            c = np.asarray(_color_for(seg["id"]), np.float32)
            base[m] = base[m] * (1 - self._alpha) + c * self._alpha
            names = self._names if seg.get("isthing", False) else stuff_names
            cat = seg.get("category_id", -1)
            label = names[cat] if names and 0 <= cat < len(names) else str(cat)
            ys, xs = np.nonzero(m)
            draw_labels.append((float(xs.mean()), float(ys.mean()), label,
                                tuple(int(v) for v in c)))
        out = Image.fromarray(base.astype(np.uint8))
        d = ImageDraw.Draw(out)
        for x, y, label, c in draw_labels:
            d.text((x, y), label, fill=c)
        self._img = out
        return np.asarray(out)

    def get_image(self) -> np.ndarray:
        return np.asarray(self._img)


class VideoVisualizer:
    """Color-consistent drawing across frames, keyed by track id
    (reference: detectron2/utils/video_visualizer.py)."""

    def __init__(self, class_names: Optional[Sequence[str]] = None):
        self._names = class_names
        self._colors: Dict[int, Color] = {}

    def draw_frame(
        self,
        frame_rgb: np.ndarray,
        track_ids: Sequence[int],
        boxes: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        scores: Optional[np.ndarray] = None,
        masks: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        colors = []
        for tid in track_ids:
            if tid not in self._colors:
                self._colors[tid] = _color_for(len(self._colors))
            colors.append(self._colors[tid])
        vis = Visualizer(frame_rgb, self._names)
        return vis.draw_instances(
            boxes=boxes, labels=labels, scores=scores, masks=masks,
            colors=colors, track_ids=track_ids,
        )
