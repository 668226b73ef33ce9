"""Host-side (numpy / PIL) transforms with box, mask and keypoint propagation.

Counterpart of ``vnext_tpu.data.transforms``: the deterministic transforms
(resize, horizontal and vertical flip, crop, pad, extent, rotation, the
photometric blend, no-op and their list), the keypoint annotation transform,
and the per-clip policy ``ClipAugmentation`` the YTVIS and COCO mappers run,
whose draws from one ``random.Random`` come in the JAX package's order (short
side, crop height, crop width, crop origin, flip), so that a seed gives both
packages the same clip. Images resample through PIL, as the JAX package's do.
The random policies that build these transforms are in ``augmentation.py``.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

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


class VFlipTransform(Transform):
    def __init__(self, height: int):
        self.height = height

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(img[::-1])

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        coords = coords.copy()
        coords[:, 1] = self.height - coords[:, 1]
        return coords

    def inverse(self) -> "VFlipTransform":
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


class PadTransform(Transform):
    """Pad by (x0, y0) on the top-left and (x1, y1) on the bottom-right
    (reference fvcore PadTransform, used by FixedSizeCrop)."""

    def __init__(self, x0: int, y0: int, x1: int, y1: int,
                 pad_value: float = 0.0, seg_pad_value: int = 0):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.pad_value = pad_value
        self.seg_pad_value = seg_pad_value

    def _pad(self, img, value):
        pads = [(self.y0, self.y1), (self.x0, self.x1)] + [(0, 0)] * (img.ndim - 2)
        return np.pad(img, pads, constant_values=value).astype(img.dtype)

    def apply_image(self, img):
        return self._pad(img, self.pad_value)

    def apply_segmentation(self, segmentation):
        return self._pad(segmentation, self.seg_pad_value)

    def apply_coords(self, coords):
        coords = coords.copy()
        coords[:, 0] += self.x0
        coords[:, 1] += self.y0
        return coords


class ExtentTransform(Transform):
    """Resample a (possibly out-of-bounds, zero-padded) source rectangle to a
    fixed output size (reference fvcore ExtentTransform via PIL EXTENT; used
    by RandomExtent)."""

    def __init__(self, src_rect, output_size, interp=Image.BILINEAR, fill=0):
        self.src_rect = tuple(float(v) for v in src_rect)  # x0, y0, x1, y1
        self.output_size = tuple(int(v) for v in output_size)  # h, w
        self.interp = interp
        self.fill = fill

    def _apply(self, img, interp):
        h, w = self.output_size
        if len(img.shape) > 2 and img.shape[2] == 1:
            pil = Image.fromarray(img[:, :, 0])
        else:
            pil = Image.fromarray(img)
        pil = pil.transform(
            size=(w, h), method=Image.EXTENT, data=self.src_rect,
            resample=interp, fill=self.fill,
        )
        out = np.asarray(pil)
        if len(img.shape) > 2 and img.shape[2] == 1:
            out = out[:, :, None]
        return out

    def apply_image(self, img):
        return self._apply(img, self.interp)

    def apply_segmentation(self, segmentation):
        return self._apply(segmentation, Image.NEAREST)

    def apply_coords(self, coords):
        x0, y0, x1, y1 = self.src_rect
        h, w = self.output_size
        coords = coords.astype(np.float64).copy()
        coords[:, 0] = (coords[:, 0] - x0) * (w / max(x1 - x0, 1e-9))
        coords[:, 1] = (coords[:, 1] - y0) * (h / max(y1 - y0, 1e-9))
        return coords


class BlendTransform(Transform):
    """Photometric blend: img * src_weight + src_image * dst_weight — the
    reference's brightness/contrast/saturation primitive
    (fvcore BlendTransform used by augmentation_impl.py RandomBrightness:552,
    RandomContrast:528, RandomSaturation:576). Geometry is identity."""

    def __init__(self, src_image, src_weight: float, dst_weight: float):
        self.src_image = src_image
        self.src_weight = src_weight
        self.dst_weight = dst_weight

    def apply_image(self, img):
        out = self.src_weight * self.src_image + self.dst_weight * img.astype(np.float64)
        return np.clip(out, 0, 255).astype(img.dtype)

    def apply_coords(self, coords):
        return coords

    def apply_segmentation(self, segmentation):
        return segmentation


def random_brightness(rng, lo: float = 0.9, hi: float = 1.1) -> BlendTransform:
    return BlendTransform(0.0, 0.0, rng.uniform(lo, hi))


def random_contrast(img, rng, lo: float = 0.9, hi: float = 1.1) -> BlendTransform:
    w = rng.uniform(lo, hi)
    return BlendTransform(float(img.mean()), 1 - w, w)


def random_saturation(img, rng, lo: float = 0.9, hi: float = 1.1) -> BlendTransform:
    w = rng.uniform(lo, hi)
    grey = img.astype(np.float64) @ np.asarray([0.299, 0.587, 0.114])
    return BlendTransform(grey[:, :, None], 1 - w, w)


class RotationTransform(Transform):
    """Rotate by ``angle`` degrees around ``center`` (default: image center).

    expand=True grows the canvas to hold the whole rotated image (reference
    augmentation_impl.py:392 RandomRotation); expand=False keeps the original
    size, cropping corners — the IDOL rotation recipe
    (idol/data/augmentation.py:153 uses expand=False with a random center).
    """

    def __init__(self, h: int, w: int, angle: float, expand: bool = True,
                 center: Optional[Tuple[float, float]] = None):
        self.h, self.w, self.angle = h, w, float(angle)
        self.expand = expand
        rad = np.deg2rad(self.angle)
        # PIL rounds the matrix coefficients to 15 decimals (Image.rotate), so
        # exact angles like 90 deg produce exact bounds — match it
        c, s = round(float(np.cos(rad)), 15), round(float(np.sin(rad)), 15)
        # rotation in array (y-down) coords: PIL rotates counterclockwise in
        # display coords, which is the matrix [[c, s], [-s, c]] here
        self._m = np.asarray([[c, s], [-s, c]])
        self._center = np.asarray(center if center is not None else (w / 2.0, h / 2.0))
        if expand:
            # expanded bounds, computed exactly like PIL.Image.rotate(expand=True)
            corners = np.asarray([[0, 0], [w, 0], [w, h], [0, h]], np.float64)
            rel = corners - np.asarray([w / 2.0, h / 2.0])
            rot = rel @ self._m.T
            self.new_w = int(np.ceil(rot[:, 0].max()) - np.floor(rot[:, 0].min()))
            self.new_h = int(np.ceil(rot[:, 1].max()) - np.floor(rot[:, 1].min()))
            self._new_center = np.asarray([self.new_w / 2.0, self.new_h / 2.0])
        else:
            self.new_w, self.new_h = w, h
            self._new_center = self._center

    def _rotate(self, img, resample):
        pil = Image.fromarray(img)
        out = pil.rotate(
            self.angle, resample=resample, expand=self.expand,
            center=None if self.expand else tuple(self._center),
        )
        arr = np.asarray(out)
        # PIL's expand uses the same bounds formula; pad/crop for rounding skew
        if arr.shape[0] != self.new_h or arr.shape[1] != self.new_w:
            fixed = np.zeros((self.new_h, self.new_w) + arr.shape[2:], arr.dtype)
            fixed[: arr.shape[0], : arr.shape[1]] = arr[: self.new_h, : self.new_w]
            arr = fixed
        return arr

    def apply_image(self, img):
        return self._rotate(img, Image.BILINEAR)

    def apply_segmentation(self, segmentation):
        return self._rotate(segmentation, Image.NEAREST)

    def apply_coords(self, coords):
        return (coords - self._center) @ self._m.T + self._new_center


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


def count_hflips(transform) -> int:
    """Number of HFlipTransforms in a (possibly nested) transform (list)."""
    if isinstance(transform, TransformList):
        return sum(count_hflips(t) for t in transform.transforms)
    return int(isinstance(transform, HFlipTransform))


def transform_keypoint_annotations(keypoints, transforms, image_size, keypoint_hflip_indices=None):
    """Transform COCO keypoint annotations ([x,y,vis]*K flat or [K,3]).

    Semantics mirror the reference detection_utils.py transform_keypoint_annotations:
    apply_coords on xy, out-of-image points become unlabeled (vis=0), an odd number
    of horizontal flips permutes the keypoint order by the flip map, and unlabeled
    keypoints are zeroed (COCO convention). ``image_size`` is (h, w) AFTER transform.
    """
    keypoints = np.asarray(keypoints, dtype=np.float64).reshape(-1, 3)
    keypoints_xy = transforms.apply_coords(keypoints[:, :2].copy())
    inside = (keypoints_xy >= np.array([0, 0])) & (
        keypoints_xy <= np.array(image_size[::-1])
    )
    inside = inside.all(axis=1)
    keypoints[:, :2] = keypoints_xy
    keypoints[:, 2][~inside] = 0
    if count_hflips(transforms) % 2 == 1:
        if keypoint_hflip_indices is None:
            raise ValueError("Cannot flip keypoints without providing flip indices!")
        if len(keypoints) != len(keypoint_hflip_indices):
            raise ValueError(
                f"Keypoint data has {len(keypoints)} points, but metadata "
                f"contains {len(keypoint_hflip_indices)} points!"
            )
        keypoints = keypoints[np.asarray(keypoint_hflip_indices, dtype=np.int32)]
    keypoints[keypoints[:, 2] == 0] = 0
    return keypoints
