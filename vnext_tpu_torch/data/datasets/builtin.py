"""The builtin splits of LVIS, Pascal VOC, Cityscapes and COCO panoptic,
registered by name under one root.

Counterpart of ``vnext_tpu.data.datasets.builtin`` (reference surface:
detectron2/data/datasets/builtin.py): the same split names and paths, under
``root`` or ``$VNEXT_DATASETS`` (default ``datasets``); each split loads
lazily, and a name already registered stays as it is. ``register_all_builtin``
also registers the COCO and YouTube-VIS splits.
"""

from __future__ import annotations

import os
from typing import Optional

from ..catalog import DatasetCatalog
from .cityscapes import register_cityscapes
from .coco_panoptic import register_coco_panoptic
from .lvis import register_lvis_instances
from .pascal_voc import register_pascal_voc

_PREDEFINED_LVIS = {
    "lvis_v1_train": ("coco/", "lvis/lvis_v1_train.json"),
    "lvis_v1_val": ("coco/", "lvis/lvis_v1_val.json"),
    "lvis_v1_test_dev": ("coco/", "lvis/lvis_v1_image_info_test_dev.json"),
    "lvis_v0.5_train": ("coco/", "lvis/lvis_v0.5_train.json"),
    "lvis_v0.5_val": ("coco/", "lvis/lvis_v0.5_val.json"),
    "lvis_v0.5_test": ("coco/", "lvis/lvis_v0.5_image_info_test.json"),
}

_PREDEFINED_VOC = [
    ("voc_2007_trainval", "VOC2007", "trainval", 2007),
    ("voc_2007_train", "VOC2007", "train", 2007),
    ("voc_2007_val", "VOC2007", "val", 2007),
    ("voc_2007_test", "VOC2007", "test", 2007),
    ("voc_2012_trainval", "VOC2012", "trainval", 2012),
    ("voc_2012_train", "VOC2012", "train", 2012),
    ("voc_2012_val", "VOC2012", "val", 2012),
]

_PREDEFINED_CITYSCAPES = {
    "cityscapes_fine_instance_seg_train": ("cityscapes/leftImg8bit/train", "cityscapes/gtFine/train", "instance"),
    "cityscapes_fine_instance_seg_val": ("cityscapes/leftImg8bit/val", "cityscapes/gtFine/val", "instance"),
    "cityscapes_fine_sem_seg_train": ("cityscapes/leftImg8bit/train", "cityscapes/gtFine/train", "sem_seg"),
    "cityscapes_fine_sem_seg_val": ("cityscapes/leftImg8bit/val", "cityscapes/gtFine/val", "sem_seg"),
}

_PREDEFINED_COCO_PANOPTIC = {
    "coco_2017_train_panoptic": ("coco/train2017", "coco/panoptic_train2017",
                                 "coco/annotations/panoptic_train2017.json"),
    "coco_2017_val_panoptic": ("coco/val2017", "coco/panoptic_val2017", "coco/annotations/panoptic_val2017.json"),
}

# every name registered here, by family
BUILTIN_NAMES = (*_PREDEFINED_LVIS, *(n for n, *_ in _PREDEFINED_VOC), *_PREDEFINED_CITYSCAPES,
                 *_PREDEFINED_COCO_PANOPTIC)


def _root(root: Optional[str]) -> str:
    return root or os.environ.get("VNEXT_DATASETS", "datasets")


def register_all_lvis(root: Optional[str] = None) -> None:
    root = _root(root)
    for name, (image_dir, json_path) in _PREDEFINED_LVIS.items():
        if name not in DatasetCatalog:
            register_lvis_instances(name, {}, os.path.join(root, json_path), os.path.join(root, image_dir))


def register_all_pascal_voc(root: Optional[str] = None) -> None:
    root = _root(root)
    for name, dirname, split, year in _PREDEFINED_VOC:
        if name not in DatasetCatalog:
            register_pascal_voc(name, os.path.join(root, dirname), split, year)


def register_all_cityscapes(root: Optional[str] = None) -> None:
    root = _root(root)
    for name, (image_dir, gt_dir, task) in _PREDEFINED_CITYSCAPES.items():
        if name not in DatasetCatalog:
            register_cityscapes(name, os.path.join(root, image_dir), os.path.join(root, gt_dir), task=task)


def register_all_coco_panoptic(root: Optional[str] = None) -> None:
    root = _root(root)
    for name, (image_root, pan_root, pan_json) in _PREDEFINED_COCO_PANOPTIC.items():
        if name not in DatasetCatalog:
            register_coco_panoptic(name, {}, os.path.join(root, image_root), os.path.join(root, pan_root),
                                   os.path.join(root, pan_json))


def register_all_builtin(root: Optional[str] = None) -> None:
    """Register every predefined split: COCO's, YouTube-VIS's and the four families above."""
    from .coco import register_all_coco
    from .ytvis import register_all_ytvis

    register_all_coco(root)
    register_all_ytvis(root)
    register_all_lvis(root)
    register_all_pascal_voc(root)
    register_all_cityscapes(root)
    register_all_coco_panoptic(root)
