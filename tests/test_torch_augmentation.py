"""The port's augmentation policies and the remaining transforms against the
JAX package's, on the CPU.

Both packages run numpy and PIL on the host and draw from the generator they
are given, so for the same ``numpy.random.RandomState`` every policy must
return the same transforms and every image, box, segmentation and keypoint
array must come out equal, bit for bit (no tolerance anywhere in this file):

- each transform the mappers do not run (vertical flip, pad, extent, the
  photometric blend and its three random builders, rotation with and without
  expansion), on an image, a mask, boxes, coordinates and polygons;
- every policy of ``augmentation.py`` (flip, resize, shortest edge in each
  sampling style, scale, rotation, the four crop types and the category-area
  constraint, extent, contrast, brightness, saturation, lighting, the fixed-size
  crop and its pad, ``RandomApply``), driven through ``AugInput`` with boxes and
  a segmentation, clip-consistent draws included;
- ``build_idol_augmentation`` on the COCO-pretrain yaml, train and test;
- ``transform_keypoint_annotations`` and ``count_hflips``.
"""

import os
import re

import numpy as np
import pytest

from vnext_tpu.config import add_idol_config as jax_add_idol_config
from vnext_tpu.config import get_cfg as jax_get_cfg
from vnext_tpu.data import augmentation as jax_A
from vnext_tpu.data import transforms as jax_T
from vnext_tpu_torch.config import add_idol_config, get_cfg
from vnext_tpu_torch.data import augmentation as A
from vnext_tpu_torch.data import transforms as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAIN = os.path.join(REPO, "configs", "idol", "coco_pretrain", "r50_coco_sequence.yaml")


def _image(seed, h=48, w=80):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    seg = rng.randint(0, 4, (h, w)).astype(np.uint8)
    boxes = np.asarray([[3.0, 4.0, 40.5, 30.0], [60.0, 1.0, 79.0, 47.0]])
    return img, seg, boxes


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), what


TRANSFORMS = {
    "vflip": lambda m: m.VFlipTransform(48),
    "pad": lambda m: m.PadTransform(3, 5, 7, 2, pad_value=128.0, seg_pad_value=255),
    "extent": lambda m: m.ExtentTransform((-6.5, 4.0, 70.25, 52.0), (40, 64)),
    "blend": lambda m: m.BlendTransform(90.0, 0.4, 0.7),
    "rotate_expand": lambda m: m.RotationTransform(48, 80, 27.5, expand=True),
    "rotate_center": lambda m: m.RotationTransform(48, 80, -12.0, expand=False, center=(30.0, 20.0)),
    "rotate_90": lambda m: m.RotationTransform(48, 80, 90.0, expand=True),
    "list": lambda m: m.TransformList([m.PadTransform(2, 2, 2, 2), m.VFlipTransform(52),
                                       m.RotationTransform(52, 84, 10.0, expand=False)]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_equals_jax(name):
    img, seg, boxes = _image(1)
    rng = np.random.RandomState(2)
    polys = [rng.rand(8) * 40]
    got, want = TRANSFORMS[name](T), TRANSFORMS[name](jax_T)
    for fn, arg in (("apply_image", img), ("apply_image", seg), ("apply_segmentation", seg),
                    ("apply_box", boxes), ("apply_coords", boxes.reshape(-1, 2))):
        _same(getattr(got, fn)(arg.copy()), getattr(want, fn)(arg.copy()), f"{name} {fn}")
    for a, b in zip(got.apply_polygons(polys), want.apply_polygons(polys)):
        _same(a, b, f"{name} polygons")


def test_random_blends_equal_jax():
    img, _, _ = _image(3)
    for make in (lambda m, r: m.random_brightness(r), lambda m, r: m.random_contrast(img, r),
                 lambda m, r: m.random_saturation(img, r)):
        got, want = make(T, np.random.RandomState(4)), make(jax_T, np.random.RandomState(4))
        _same(got.apply_image(img), want.apply_image(img), "blend")
        _same(got.apply_coords(np.ones((2, 2))), want.apply_coords(np.ones((2, 2))), "coords")


POLICIES = {
    "flip_h": lambda m, r: m.RandomFlip(0.5, rng=r),
    "flip_v_clip": lambda m, r: m.RandomFlip(0.5, horizontal=False, vertical=True, clip_frame_cnt=2, rng=r),
    "resize": lambda m, r: m.Resize((37, 61)),
    "shortest_choice": lambda m, r: m.ResizeShortestEdge([32, 40, 56], 90, "choice", rng=r),
    "shortest_range": lambda m, r: m.ResizeShortestEdge((30, 60), 100, "range", rng=r),
    "shortest_by_clip": lambda m, r: m.ResizeShortestEdge([32, 40, 56], 90, "choice_by_clip", clip_frame_cnt=2,
                                                          rng=r),
    "scale": lambda m, r: m.ResizeScale(0.5, 1.5, 64, 96, rng=r),
    "rotation": lambda m, r: m.RandomRotation([-15, 15], expand=False, center=[(0.4, 0.4), (0.6, 0.6)], rng=r),
    "rotation_choice": lambda m, r: m.RandomRotation([0, 90, 180], expand=True, sample_style="choice", rng=r),
    "crop_relative": lambda m, r: m.RandomCrop("relative", (0.5, 0.75), rng=r),
    "crop_relative_range": lambda m, r: m.RandomCrop("relative_range", (0.3, 0.5), rng=r),
    "crop_absolute": lambda m, r: m.RandomCrop("absolute", (30, 50), rng=r),
    "crop_absolute_range": lambda m, r: m.RandomCrop("absolute_range", (20, 60), clip_frame_cnt=2, rng=r),
    "crop_category_area": lambda m, r: m.RandomCrop_CategoryAreaConstraint("absolute", (20, 30), 0.3,
                                                                            ignored_category=0, rng=r),
    "extent": lambda m, r: m.RandomExtent((0.8, 1.2), (0.3, 0.2), rng=r),
    "contrast": lambda m, r: m.RandomContrast(0.9, 1.1, rng=r),
    "brightness": lambda m, r: m.RandomBrightness(0.9, 1.1, rng=r),
    "saturation": lambda m, r: m.RandomSaturation(0.9, 1.1, rng=r),
    "lighting": lambda m, r: m.RandomLighting(0.1, rng=r),
    "fixed_crop": lambda m, r: m.FixedSizeCrop((30, 50), rng=r),
    "fixed_pad": lambda m, r: m.FixedSizeCrop((64, 100), rng=r),
    "apply": lambda m, r: m.RandomApply(m.RandomContrast(0.5, 1.5, rng=r), prob=0.5, rng=r),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_equals_jax(name):
    """Three successive calls of one policy (clip-consistent draws repeat or
    redraw as in JAX), each on a fresh ``AugInput`` with boxes and a
    segmentation; the generators must also end in the same state."""
    rngs = np.random.RandomState(5), np.random.RandomState(5)
    got, want = POLICIES[name](A, rngs[0]), POLICIES[name](jax_A, rngs[1])
    for call in range(3):
        img, seg, boxes = _image(10 + call)
        ins = A.AugInput(img.copy(), boxes=boxes.copy(), sem_seg=seg.copy())
        jins = jax_A.AugInput(img.copy(), boxes=boxes.copy(), sem_seg=seg.copy())
        tfm, jtfm = got(ins), want(jins)
        assert type(tfm).__name__ == type(jtfm).__name__, (name, call)
        for field in ("image", "boxes", "sem_seg"):
            _same(getattr(ins, field), getattr(jins, field), f"{name} call {call} {field}")
    assert rngs[0].randint(1 << 30) == rngs[1].randint(1 << 30), name


def test_augmentation_list_and_functional_form_equal_jax():
    img, seg, boxes = _image(20)
    for module_fn in ("list", "functional"):
        outs = []
        for m in (A, jax_A):
            r = np.random.RandomState(21)
            augs = [m.RandomFlip(rng=r), m.ResizeShortestEdge([40, 56], 100, rng=r), m.RandomBrightness(0.8, 1.2, rng=r),
                    T.HFlipTransform(0) if m is A else jax_T.HFlipTransform(0)]
            ins = m.AugInput(img.copy(), boxes=boxes.copy(), sem_seg=seg.copy())
            tl = ins.apply_augmentations(augs) if module_fn == "list" else m.apply_augmentations(augs, ins)
            outs.append((ins, [type(t).__name__ for t in tl.transforms]))
        (ins, names), (jins, jnames) = outs
        assert names == jnames
        for field in ("image", "boxes", "sem_seg"):
            _same(getattr(ins, field), getattr(jins, field), f"{module_fn} {field}")


def _settings(aug):
    """A policy's repr without its generator's address."""
    return re.sub(r" at 0x[0-9A-Fa-f]+", "", repr(aug))


def _pretrain_cfgs(*opts):
    cfgs = []
    for get, add in ((get_cfg, add_idol_config), (jax_get_cfg, jax_add_idol_config)):
        cfg = get()
        add(cfg)
        cfg.merge_from_file(PRETRAIN)
        cfg.merge_from_list(list(opts))
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize("is_train", [True, False])
def test_build_idol_augmentation_on_the_pretrain_yaml(is_train):
    """The yaml's crop (absolute_range 384-600), shortest-edge choice by clip
    (2 frames) and flip by clip: a (no crop, with crop) pair in training, one
    shortest-edge resize to 480 for testing; driven on a COCO-sized image, each
    list gives JAX's transforms."""
    cfg, jcfg = _pretrain_cfgs("INPUT.AUGMENTATIONS", "['brightness', 'saturation']")
    got = A.build_idol_augmentation(cfg, is_train, rng=np.random.RandomState(30))
    want = jax_A.build_idol_augmentation(jcfg, is_train, rng=np.random.RandomState(30))
    lists = got if is_train else [got]
    jlists = want if is_train else [want]
    assert len(lists) == len(jlists) == (2 if is_train else 1)
    if is_train:
        assert [type(a).__name__ for a in lists[1]] == ["RandomCrop", "ResizeShortestEdge", "RandomFlip",
                                                        "RandomBrightness", "RandomSaturation"]
        assert lists[1][1].clip_frame_cnt == lists[1][2].clip_frame_cnt == 2 and lists[0] == lists[1][1:]
    else:
        assert [type(a).__name__ for a in lists[0]] == ["ResizeShortestEdge"]
    for augs, jaugs in zip(lists, jlists):
        assert [_settings(a) for a in augs] == [_settings(a) for a in jaugs]
        for frame in range(2):
            img, seg, boxes = _image(31 + frame, h=427, w=640)
            ins = A.AugInput(img.copy(), boxes=boxes.copy(), sem_seg=seg.copy())
            jins = jax_A.AugInput(img.copy(), boxes=boxes.copy(), sem_seg=seg.copy())
            A.AugmentationList(augs)(ins)
            jax_A.AugmentationList(jaugs)(jins)
            for field in ("image", "boxes", "sem_seg"):
                _same(getattr(ins, field), getattr(jins, field), f"frame {frame} {field}")


@pytest.mark.parametrize("flips", [0, 1, 2])
def test_keypoint_annotations_equal_jax(flips):
    rng = np.random.RandomState(40 + flips)
    kps = np.concatenate([rng.rand(17, 2) * [90, 60], rng.randint(0, 3, (17, 1))], axis=1).reshape(-1).tolist()
    flip_idx = list(range(17))[::-1]
    got_t = T.TransformList([T.ResizeTransform(48, 80, 60, 100)] + [T.HFlipTransform(100)] * flips)
    want_t = jax_T.TransformList([jax_T.ResizeTransform(48, 80, 60, 100)] + [jax_T.HFlipTransform(100)] * flips)
    assert T.count_hflips(got_t) == jax_T.count_hflips(want_t) == flips
    got = T.transform_keypoint_annotations(kps, got_t, (60, 100), flip_idx)
    want = jax_T.transform_keypoint_annotations(kps, want_t, (60, 100), flip_idx)
    _same(got, want, "keypoints")
    if flips % 2:
        with pytest.raises(ValueError, match="flip indices"):
            T.transform_keypoint_annotations(kps, got_t, (60, 100))
