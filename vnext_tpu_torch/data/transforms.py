"""Host-side (numpy / PIL) clip augmentation with box and mask propagation.

Counterpart of the part of ``vnext_tpu.data.transforms`` the YTVIS mapper runs:
the transforms (resize, horizontal flip, crop, no-op and their list) and the
per-clip policy ``ClipAugmentation``, whose draws from one ``random.Random``
come in the JAX package's order (short side, crop height, crop width, crop
origin, flip), so that a seed gives both packages the same clip. Images resize
through PIL's bilinear filter, as the JAX package's do. Rotation, extent, blend
and keypoint transforms are not ported yet.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image


class Transform:
    """A deterministic, applied transform (image + geometry)."""

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_segmentation(self, segmentation: np.ndarray) -> np.ndarray:
        """Like an image, unless the transform resamples (nearest there)."""
        return self.apply_image(segmentation)

    def inverse(self) -> "Transform":
        raise NotImplementedError(f"{type(self).__name__} is not invertible")

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        """boxes: [N, 4] xyxy -> the boxes around their transformed corners."""
        if len(boxes) == 0:
            return boxes
        corners = boxes.reshape(-1, 2, 2).reshape(-1, 2)
        corners = self.apply_coords(corners.astype(np.float64)).reshape(-1, 2, 2)
        mins = corners.min(axis=1)
        maxs = corners.max(axis=1)
        return np.concatenate([mins, maxs], axis=1).astype(boxes.dtype)

    def apply_polygons(self, polygons: List[np.ndarray]) -> List[np.ndarray]:
        return [self.apply_coords(p.reshape(-1, 2).astype(np.float64)).reshape(-1) for p in polygons]


class ResizeTransform(Transform):
    def __init__(self, h: int, w: int, new_h: int, new_w: int):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        pil = Image.fromarray(img)
        pil = pil.resize((self.new_w, self.new_h), Image.BILINEAR)
        return np.asarray(pil)

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        coords = coords.copy()
        coords[:, 0] *= self.new_w / self.w
        coords[:, 1] *= self.new_h / self.h
        return coords

    def apply_segmentation(self, segmentation: np.ndarray) -> np.ndarray:
        pil = Image.fromarray(segmentation)
        return np.asarray(pil.resize((self.new_w, self.new_h), Image.NEAREST))

    def inverse(self) -> "ResizeTransform":
        return ResizeTransform(self.new_h, self.new_w, self.h, self.w)


class HFlipTransform(Transform):
    def __init__(self, width: int):
        self.width = width

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(img[:, ::-1])

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        coords = coords.copy()
        coords[:, 0] = self.width - coords[:, 0]
        return coords

    def inverse(self) -> "HFlipTransform":
        return self


class CropTransform(Transform):
    def __init__(self, x0: int, y0: int, w: int, h: int):
        self.x0, self.y0, self.w, self.h = x0, y0, w, h

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(img[self.y0 : self.y0 + self.h, self.x0 : self.x0 + self.w])

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        coords = coords.copy()
        coords[:, 0] -= self.x0
        coords[:, 1] -= self.y0
        return coords


class NoOpTransform(Transform):
    def apply_image(self, img):
        return img

    def apply_coords(self, coords):
        return coords

    def inverse(self) -> "NoOpTransform":
        return self


class TransformList(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def apply_image(self, img):
        for t in self.transforms:
            img = t.apply_image(img)
        return img

    def apply_coords(self, coords):
        for t in self.transforms:
            coords = t.apply_coords(coords)
        return coords

    def apply_segmentation(self, segmentation):
        for t in self.transforms:
            segmentation = t.apply_segmentation(segmentation)
        return segmentation

    def inverse(self) -> "TransformList":
        return TransformList([t.inverse() for t in self.transforms[::-1]])


def get_resize_shortest_edge(h: int, w: int, short_edge: int, max_size: int) -> ResizeTransform:
    """detectron2 ResizeShortestEdge geometry."""
    scale = short_edge / min(h, w)
    if h < w:
        new_h, new_w = short_edge, int(round(scale * w))
    else:
        new_h, new_w = int(round(scale * h)), short_edge
    if max(new_h, new_w) > max_size:
        scale2 = max_size / max(new_h, new_w)
        new_h = int(round(new_h * scale2))
        new_w = int(round(new_w * scale2))
    return ResizeTransform(h, w, new_h, new_w)


class ClipAugmentation:
    """Per-clip augmentation policy: one random draw shared by all frames
    (``INPUT.MIN_SIZE_TRAIN_SAMPLING`` "choice_by_clip", ``RANDOM_FLIP``
    "flip_by_clip"): a shortest-edge resize, an "absolute_range" crop and a
    horizontal flip with probability 0.5, in that order."""

    def __init__(
        self,
        min_sizes: Sequence[int],
        max_size: int,
        flip: bool = True,
        crop_type: Optional[str] = None,
        crop_size: Optional[Sequence[float]] = None,
        is_train: bool = True,
    ):
        self.min_sizes = list(min_sizes)
        self.max_size = max_size
        self.flip = flip
        self.crop_type = crop_type
        self.crop_size = crop_size
        self.is_train = is_train

    def build(self, h: int, w: int, rng: random.Random) -> TransformList:
        tfms: List[Transform] = []
        short = rng.choice(self.min_sizes) if self.is_train else self.min_sizes[0]
        resize = get_resize_shortest_edge(h, w, short, self.max_size)
        tfms.append(resize)
        cur_h, cur_w = resize.new_h, resize.new_w
        if self.is_train and self.crop_type == "absolute_range" and self.crop_size:
            ch = rng.randint(min(int(self.crop_size[0]), cur_h), min(int(self.crop_size[1]), cur_h))
            cw = rng.randint(min(int(self.crop_size[0]), cur_w), min(int(self.crop_size[1]), cur_w))
            y0 = rng.randint(0, cur_h - ch)
            x0 = rng.randint(0, cur_w - cw)
            tfms.append(CropTransform(x0, y0, cw, ch))
            cur_h, cur_w = ch, cw
        if self.is_train and self.flip and rng.random() < 0.5:
            tfms.append(HFlipTransform(cur_w))
        return TransformList(tfms)
