"""Augmentation policy API (host-side, numpy).

Counterpart of ``vnext_tpu.data.augmentation``: an ``Augmentation`` is a
policy that inspects an ``AugInput`` and returns a deterministic
``Transform`` (``transforms.py``); ``AugmentationList`` applies a sequence and
returns the composed ``TransformList``. The policies are detectron2's
(``RandomFlip``, ``Resize``, ``ResizeShortestEdge``, ``ResizeScale``,
``RandomRotation``, ``RandomCrop`` with its category-area constraint,
``RandomExtent``, ``RandomBrightness`` / ``Contrast`` / ``Saturation`` /
``Lighting``, ``FixedSizeCrop``) with IDOL's clip-consistent variants: one
draw shared by ``clip_frame_cnt`` successive calls. Each policy draws from its
``rng`` (a ``numpy.random.RandomState``), or from the global ``np.random``
without one, in the JAX package's order, so one generator state gives both
packages the same transforms. ``build_idol_augmentation`` reads
``INPUT.MIN_SIZE_TRAIN_SAMPLING``, ``INPUT.RANDOM_FLIP``, ``INPUT.CROP`` and
``INPUT.AUGMENTATIONS``.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .transforms import (
    BlendTransform,
    CropTransform,
    ExtentTransform,
    HFlipTransform,
    NoOpTransform,
    PadTransform,
    ResizeTransform,
    RotationTransform,
    Transform,
    TransformList,
    VFlipTransform,
    get_resize_shortest_edge,
)


class AugInput:
    """Mutable input bundle an Augmentation may inspect and transform.

    Attributes (any may be None): image [H, W, C] uint8/float, boxes [N, 4]
    xyxy float, sem_seg [H, W] int.
    """

    def __init__(self, image: np.ndarray, *, boxes=None, sem_seg=None):
        self.image = image
        self.boxes = boxes
        self.sem_seg = sem_seg

    def transform(self, tfm: Transform) -> None:
        self.image = tfm.apply_image(self.image)
        if self.boxes is not None:
            self.boxes = tfm.apply_box(self.boxes)
        if self.sem_seg is not None:
            self.sem_seg = tfm.apply_segmentation(self.sem_seg)

    def apply_augmentations(self, augmentations: Sequence["Augmentation"]) -> TransformList:
        return AugmentationList(augmentations)(self)


class Augmentation:
    """Policy base: ``get_transform(aug_input) -> Transform``."""

    # subclasses may set this to share one draw across a clip's frames
    clip_frame_cnt: int = 1

    def get_transform(self, aug_input: AugInput) -> Transform:
        raise NotImplementedError

    def __call__(self, aug_input: AugInput) -> Transform:
        tfm = self.get_transform(aug_input)
        assert isinstance(tfm, Transform), type(tfm)
        aug_input.transform(tfm)
        return tfm

    def _rand(self):
        return getattr(self, "rng", None) or np.random

    def __repr__(self):
        attrs = ", ".join(
            f"{k}={v!r}" for k, v in sorted(vars(self).items()) if not k.startswith("_")
        )
        return f"{type(self).__name__}({attrs})"


class AugmentationList(Augmentation):
    def __init__(self, augs: Sequence[Union[Augmentation, Transform]]):
        self.augs = [_wrap(a) for a in augs]

    def __call__(self, aug_input: AugInput) -> TransformList:
        tfms = []
        for a in self.augs:
            tfms.append(a(aug_input))
        return TransformList(tfms)

    get_transform = None  # not used; __call__ composes


def _wrap(a):
    if isinstance(a, Transform):
        t = a

        class _Fixed(Augmentation):
            def get_transform(self, aug_input):
                return t

        return _Fixed()
    return a


def apply_augmentations(augmentations, aug_input: AugInput) -> TransformList:
    """Functional form (reference augmentation.py apply_augmentations)."""
    return AugmentationList(augmentations)(aug_input)


class RandomApply(Augmentation):
    def __init__(self, tfm_or_aug, prob: float = 0.5, rng=None):
        self.aug = _wrap(tfm_or_aug)
        self.prob = prob
        self.rng = rng

    def get_transform(self, aug_input):
        if self._rand().uniform() < self.prob:
            return self.aug.get_transform(aug_input)
        return NoOpTransform()

    def __call__(self, aug_input):
        if self._rand().uniform() < self.prob:
            return self.aug(aug_input)
        return NoOpTransform()


class _ClipConsistent:
    """Mixin: redraw parameters only every ``clip_frame_cnt`` calls."""

    def _maybe_redraw(self, draw_fn):
        cnt = getattr(self, "_cnt", 0)
        if cnt % max(self.clip_frame_cnt, 1) == 0:
            self._drawn = draw_fn()
            cnt = 0
        self._cnt = cnt + 1
        return self._drawn


class RandomFlip(_ClipConsistent, Augmentation):
    """Horizontal or vertical flip (reference augmentation_impl.py:150 +
    IDOL's clip-consistent variant :73)."""

    def __init__(self, prob: float = 0.5, *, horizontal=True, vertical=False,
                 clip_frame_cnt: int = 1, rng=None):
        assert horizontal ^ vertical, "exactly one of horizontal/vertical"
        self.prob = prob
        self.horizontal = horizontal
        self.vertical = vertical
        self.clip_frame_cnt = clip_frame_cnt
        self.rng = rng

    def get_transform(self, aug_input):
        do = self._maybe_redraw(lambda: self._rand().uniform() < self.prob)
        h, w = aug_input.image.shape[:2]
        if not do:
            return NoOpTransform()
        return HFlipTransform(w) if self.horizontal else VFlipTransform(h)


class Resize(Augmentation):
    def __init__(self, shape: Union[int, Tuple[int, int]]):
        if isinstance(shape, int):
            shape = (shape, shape)
        self.shape = tuple(shape)

    def get_transform(self, aug_input):
        h, w = aug_input.image.shape[:2]
        return ResizeTransform(h, w, self.shape[0], self.shape[1])


class ResizeShortestEdge(_ClipConsistent, Augmentation):
    """reference augmentation_impl.py:94 + IDOL clip variant :14."""

    def __init__(self, short_edge_length, max_size: int = sys.maxsize,
                 sample_style: str = "choice", clip_frame_cnt: int = 1, rng=None):
        assert sample_style in ("range", "choice", "range_by_clip", "choice_by_clip")
        if isinstance(short_edge_length, int):
            short_edge_length = (short_edge_length, short_edge_length)
        self.short_edge_length = list(short_edge_length)
        self.max_size = max_size
        self.is_range = "range" in sample_style
        if "by_clip" not in sample_style:
            clip_frame_cnt = 1
        self.clip_frame_cnt = clip_frame_cnt
        self.rng = rng

    def get_transform(self, aug_input):
        def draw():
            if self.is_range:
                return int(self._rand().randint(
                    self.short_edge_length[0], self.short_edge_length[1] + 1))
            return int(self._rand().choice(self.short_edge_length))

        size = self._maybe_redraw(draw)
        if size == 0:
            return NoOpTransform()
        h, w = aug_input.image.shape[:2]
        return get_resize_shortest_edge(h, w, size, self.max_size)


class ResizeScale(Augmentation):
    """Scale by a random factor relative to a target size, preserving aspect
    ratio (reference augmentation_impl.py:185; the copy-paste/LSJ recipe)."""

    def __init__(self, min_scale: float, max_scale: float,
                 target_height: int, target_width: int, rng=None):
        self.min_scale, self.max_scale = min_scale, max_scale
        self.target_height, self.target_width = target_height, target_width
        self.rng = rng

    def get_transform(self, aug_input):
        h, w = aug_input.image.shape[:2]
        scale = self._rand().uniform(self.min_scale, self.max_scale)
        out_scale = min(
            scale * self.target_height / h, scale * self.target_width / w
        )
        new_h = int(h * out_scale + 0.5)
        new_w = int(w * out_scale + 0.5)
        return ResizeTransform(h, w, new_h, new_w)


class RandomRotation(_ClipConsistent, Augmentation):
    """reference augmentation_impl.py:392: angle from range/choice; optional
    non-expanding rotation about a relative center."""

    def __init__(self, angle, expand: bool = True, center=None,
                 sample_style: str = "range", clip_frame_cnt: int = 1, rng=None):
        assert sample_style in ("range", "choice")
        if isinstance(angle, (int, float)):
            angle = (angle, angle)
        self.angle = list(angle)
        self.expand = expand
        self.center = center
        self.is_range = sample_style == "range"
        self.clip_frame_cnt = clip_frame_cnt
        self.rng = rng

    def get_transform(self, aug_input):
        def draw():
            r = self._rand()
            angle = (
                float(r.uniform(self.angle[0], self.angle[1]))
                if self.is_range else float(r.choice(self.angle))
            )
            center = None
            if self.center is not None:
                (cx0, cy0), (cx1, cy1) = self.center
                center = (float(r.uniform(cx0, cx1)), float(r.uniform(cy0, cy1)))
            return angle, center

        angle, center = self._maybe_redraw(draw)
        if angle % 360 == 0:
            return NoOpTransform()
        h, w = aug_input.image.shape[:2]
        abs_center = None if center is None else (center[0] * w, center[1] * h)
        return RotationTransform(h, w, angle, expand=self.expand, center=abs_center)


class RandomCrop(_ClipConsistent, Augmentation):
    """reference augmentation_impl.py:261: crop_type in relative /
    relative_range / absolute / absolute_range."""

    def __init__(self, crop_type: str, crop_size, clip_frame_cnt: int = 1, rng=None):
        assert crop_type in ("relative_range", "relative", "absolute", "absolute_range")
        self.crop_type = crop_type
        self.crop_size = tuple(crop_size)
        self.clip_frame_cnt = clip_frame_cnt
        self.rng = rng

    def get_crop_size(self, image_size) -> Tuple[int, int]:
        h, w = image_size
        r = self._rand()
        if self.crop_type == "relative":
            ch, cw = self.crop_size
            return int(h * ch + 0.5), int(w * cw + 0.5)
        if self.crop_type == "relative_range":
            lo = np.asarray(self.crop_size, np.float32)
            ch, cw = lo + r.rand(2) * (1 - lo)
            return int(h * ch + 0.5), int(w * cw + 0.5)
        if self.crop_type == "absolute":
            return min(self.crop_size[0], h), min(self.crop_size[1], w)
        ch = r.randint(min(self.crop_size[0], h), min(self.crop_size[1], h) + 1)
        cw = r.randint(min(self.crop_size[0], w), min(self.crop_size[1], w) + 1)
        return ch, cw

    def get_transform(self, aug_input):
        h, w = aug_input.image.shape[:2]

        def draw():
            ch, cw = self.get_crop_size((h, w))
            assert ch <= h and cw <= w
            r = self._rand()
            y0 = int(r.randint(h - ch + 1))
            x0 = int(r.randint(w - cw + 1))
            return x0, y0, cw, ch

        x0, y0, cw, ch = self._maybe_redraw(draw)
        return CropTransform(x0, y0, cw, ch)


class RandomCrop_CategoryAreaConstraint(Augmentation):
    """reference augmentation_impl.py:329: retry crops until no single
    sem-seg category fills more than ``single_category_max_area``."""

    def __init__(self, crop_type: str, crop_size,
                 single_category_max_area: float = 1.0,
                 ignored_category: Optional[int] = None, rng=None):
        self.crop_aug = RandomCrop(crop_type, crop_size, rng=rng)
        self.single_category_max_area = single_category_max_area
        self.ignored_category = ignored_category
        self.rng = rng

    def get_transform(self, aug_input):
        if self.single_category_max_area >= 1.0 or aug_input.sem_seg is None:
            return self.crop_aug.get_transform(aug_input)
        h, w = aug_input.image.shape[:2]
        sem_seg = aug_input.sem_seg
        for _ in range(10):
            ch, cw = self.crop_aug.get_crop_size((h, w))
            r = self._rand()
            y0 = int(r.randint(h - ch + 1))
            x0 = int(r.randint(w - cw + 1))
            patch = sem_seg[y0 : y0 + ch, x0 : x0 + cw]
            labels, counts = np.unique(patch, return_counts=True)
            if self.ignored_category is not None:
                counts = counts[labels != self.ignored_category]
            if len(counts) > 1 and counts.max() < counts.sum() * self.single_category_max_area:
                break
        return CropTransform(x0, y0, cw, ch)


class RandomExtent(Augmentation):
    """reference augmentation_impl.py:216: crop a random scaled/shifted
    subregion (possibly out of bounds, zero-padded)."""

    def __init__(self, scale_range, shift_range, rng=None):
        self.scale_range = scale_range
        self.shift_range = shift_range
        self.rng = rng

    def get_transform(self, aug_input):
        h, w = aug_input.image.shape[:2]
        r = self._rand()
        src_rect = np.array([-0.5 * w, -0.5 * h, 0.5 * w, 0.5 * h])
        src_rect *= r.uniform(self.scale_range[0], self.scale_range[1])
        src_rect[0::2] += self.shift_range[0] * w * (r.rand() - 0.5)
        src_rect[1::2] += self.shift_range[1] * h * (r.rand() - 0.5)
        src_rect[0::2] += 0.5 * w
        src_rect[1::2] += 0.5 * h
        return ExtentTransform(
            src_rect=tuple(src_rect),
            output_size=(int(src_rect[3] - src_rect[1]), int(src_rect[2] - src_rect[0])),
        )


class RandomContrast(Augmentation):
    def __init__(self, intensity_min: float, intensity_max: float, rng=None):
        self.intensity_min, self.intensity_max = intensity_min, intensity_max
        self.rng = rng

    def get_transform(self, aug_input):
        wgt = self._rand().uniform(self.intensity_min, self.intensity_max)
        return BlendTransform(float(aug_input.image.mean()), 1 - wgt, wgt)


class RandomBrightness(Augmentation):
    def __init__(self, intensity_min: float, intensity_max: float, rng=None):
        self.intensity_min, self.intensity_max = intensity_min, intensity_max
        self.rng = rng

    def get_transform(self, aug_input):
        wgt = self._rand().uniform(self.intensity_min, self.intensity_max)
        return BlendTransform(0.0, 0.0, wgt)


class RandomSaturation(Augmentation):
    def __init__(self, intensity_min: float, intensity_max: float, rng=None):
        self.intensity_min, self.intensity_max = intensity_min, intensity_max
        self.rng = rng

    def get_transform(self, aug_input):
        img = aug_input.image
        assert img.shape[-1] == 3, "saturation needs RGB"
        wgt = self._rand().uniform(self.intensity_min, self.intensity_max)
        grey = img.astype(np.float64) @ np.asarray([0.299, 0.587, 0.114])
        return BlendTransform(grey[:, :, None], 1 - wgt, wgt)


class RandomLighting(Augmentation):
    """reference augmentation_impl.py:599: AlexNet-style PCA color jitter."""

    eigen_vecs = np.array(
        [[-0.5675, 0.7192, 0.4009],
         [-0.5808, -0.0045, -0.8140],
         [-0.5836, -0.6948, 0.4203]]
    )
    eigen_vals = np.array([0.2175, 0.0188, 0.0045])

    def __init__(self, scale: float, rng=None):
        self.scale = scale
        self.rng = rng

    def get_transform(self, aug_input):
        assert aug_input.image.shape[-1] == 3, "lighting needs RGB"
        weights = self._rand().normal(scale=self.scale, size=3)
        shift = self.eigen_vecs @ (weights * self.eigen_vals)
        return BlendTransform(shift.reshape(1, 1, 3), 1.0, 1.0)


class FixedSizeCrop(Augmentation):
    """reference augmentation_impl.py:635: crop (or pad) to an exact size."""

    def __init__(self, crop_size: Tuple[int, int], pad: bool = True,
                 pad_value: float = 128.0, seg_pad_value: int = 255, rng=None):
        self.crop_size = tuple(crop_size)
        self.pad = pad
        self.pad_value = pad_value
        self.seg_pad_value = seg_pad_value
        self.rng = rng

    def get_transform(self, aug_input):
        h, w = aug_input.image.shape[:2]
        ch, cw = self.crop_size
        tfms = []
        # crop if larger
        off_h = max(h - ch, 0)
        off_w = max(w - cw, 0)
        r = self._rand()
        y0 = int(off_h * r.rand())
        x0 = int(off_w * r.rand())
        if off_h or off_w:
            tfms.append(CropTransform(x0, y0, min(cw, w), min(ch, h)))
        if self.pad:
            pad_h = max(ch - h, 0)
            pad_w = max(cw - w, 0)
            if pad_h or pad_w or not tfms:
                tfms.append(
                    PadTransform(0, 0, pad_w, pad_h, pad_value=self.pad_value,
                                 seg_pad_value=self.seg_pad_value)
                )
        return TransformList(tfms) if tfms else NoOpTransform()


def build_idol_augmentation(cfg, is_train: bool, rng=None):
    """IDOL's crop/no-crop train branch (idol/data/augmentation.py:112).

    Returns a list of Augmentations, or a (no_crop, with_crop) pair when
    INPUT.CROP.ENABLED (the mapper picks per-sample, reference
    dataset_mapper.py usage).
    """
    if not is_train:
        return [ResizeShortestEdge(
            list(cfg.INPUT.MIN_SIZE_TEST if isinstance(cfg.INPUT.MIN_SIZE_TEST, (list, tuple))
                 else [cfg.INPUT.MIN_SIZE_TEST]),
            cfg.INPUT.MAX_SIZE_TEST, "choice", rng=rng)]

    sampling = cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING
    clip_cnt = cfg.INPUT.SAMPLING_FRAME_NUM if "by_clip" in sampling else 1
    aug_list: List[Augmentation] = []
    if cfg.INPUT.CROP.ENABLED:
        aug_list.append(RandomCrop(cfg.INPUT.CROP.TYPE, cfg.INPUT.CROP.SIZE, rng=rng))
    aug_list.append(ResizeShortestEdge(
        list(cfg.INPUT.MIN_SIZE_TRAIN), cfg.INPUT.MAX_SIZE_TRAIN, sampling,
        clip_frame_cnt=clip_cnt, rng=rng))
    if cfg.INPUT.RANDOM_FLIP != "none":
        flip_cnt = cfg.INPUT.SAMPLING_FRAME_NUM if cfg.INPUT.RANDOM_FLIP == "flip_by_clip" else 1
        aug_list.append(RandomFlip(
            horizontal=cfg.INPUT.RANDOM_FLIP in ("horizontal", "flip_by_clip"),
            vertical=cfg.INPUT.RANDOM_FLIP == "vertical",
            clip_frame_cnt=flip_cnt, rng=rng))
    extra = cfg.INPUT.AUGMENTATIONS
    if "brightness" in extra:
        aug_list.append(RandomBrightness(0.9, 1.1, rng=rng))
    if "contrast" in extra:
        aug_list.append(RandomContrast(0.9, 1.1, rng=rng))
    if "saturation" in extra:
        aug_list.append(RandomSaturation(0.9, 1.1, rng=rng))
    if "rotation" in extra:
        aug_list.append(RandomRotation(
            [-15, 15], expand=False, center=[(0.4, 0.4), (0.6, 0.6)],
            sample_style="range", rng=rng))
    if not cfg.INPUT.CROP.ENABLED:
        return aug_list
    return aug_list[1:], aug_list
