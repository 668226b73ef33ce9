"""Cityscapes: the fine instance and semantic loaders, the class tables and
a split's registration.

Counterpart of ``vnext_tpu.data.datasets.cityscapes`` (reference surface:
detectron2/data/datasets/cityscapes.py and builtin_meta.py's Cityscapes
tables). Images are ``leftImg8bit/<split>/<city>/<id>_leftImg8bit.png``,
each image id ``<city>_<seq>_<frame>``. Instances are read straight from
``gtFine/<split>/<city>/<id>_gtFine_instanceIds.png`` (a thing's pixel is
label id * 1000 + its index, a stuff pixel its label id): each instance of
the 8 thing classes becomes an RLE mask and its tight XYXY box, with
``"bbox_mode": BoxMode.XYXY_ABS`` (the JAX package's records say nothing, so
its mapper reads these boxes as XYWH: ROADMAP Queue 3, item 7). Semantic
records point at ``<id>_gtFine_labelTrainIds.png`` (19 train ids, 255 void).
"""

from __future__ import annotations

import glob
import logging
import os
from typing import List

import numpy as np

from ...structures.boxes import BoxMode
from ..catalog import DatasetCatalog, MetadataCatalog

logger = logging.getLogger("vnext_tpu_torch")

# (name, label id) of the 8 instance ("thing") classes, in contiguous order
CITYSCAPES_THING_CLASSES = (
    ("person", 24), ("rider", 25), ("car", 26), ("truck", 27),
    ("bus", 28), ("train", 31), ("motorcycle", 32), ("bicycle", 33),
)
# the 19 train ids' classes, in train id order
CITYSCAPES_SEM_SEG_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
)
_LABEL_TO_CONTIGUOUS = {lid: i for i, (_, lid) in enumerate(CITYSCAPES_THING_CLASSES)}


def _pairs(image_dir: str, gt_dir: str, gt_suffix: str) -> List[tuple]:
    """[(image file, ground-truth file, image id)] by the leftImg8bit naming."""
    out = []
    for img in sorted(glob.glob(os.path.join(image_dir, "*", "*_leftImg8bit.png"))):
        city = os.path.basename(os.path.dirname(img))
        base = os.path.basename(img)[: -len("_leftImg8bit.png")]
        out.append((img, os.path.join(gt_dir, city, base + gt_suffix), base))
    return out


def load_cityscapes_instances(image_dir: str, gt_dir: str) -> List[dict]:
    """Instance records, decoded when loaded (each instance an RLE and a box)."""
    from PIL import Image

    from ...evaluation.rle import rle_encode

    records = []
    for img_file, gt_file, image_id in _pairs(image_dir, gt_dir, "_gtFine_instanceIds.png"):
        inst_map = np.asarray(Image.open(gt_file))
        h, w = inst_map.shape[:2]
        objs = []
        for iid in np.unique(inst_map):
            if iid < 1000:  # stuff or unlabeled
                continue
            label_id = int(iid // 1000)
            if label_id not in _LABEL_TO_CONTIGUOUS:
                continue
            mask = inst_map == iid
            ys, xs = np.nonzero(mask)
            objs.append({
                "category_id": _LABEL_TO_CONTIGUOUS[label_id],
                "bbox": [float(xs.min()), float(ys.min()), float(xs.max() + 1), float(ys.max() + 1)],
                "bbox_mode": BoxMode.XYXY_ABS,
                "segmentation": rle_encode(mask),
                "iscrowd": 0,
                "id": int(iid),
            })
        records.append({"file_name": img_file, "image_id": image_id, "height": int(h), "width": int(w),
                        "annotations": objs})
    logger.info("Loaded %d Cityscapes images from %s", len(records), image_dir)
    return records


def load_cityscapes_semantic(image_dir: str, gt_dir: str) -> List[dict]:
    """Semantic records: the image and its labelTrainIds PNG."""
    records = [{"file_name": img, "sem_seg_file_name": gt, "image_id": image_id}
               for img, gt, image_id in _pairs(image_dir, gt_dir, "_gtFine_labelTrainIds.png")]
    logger.info("Loaded %d Cityscapes sem-seg images from %s", len(records), image_dir)
    return records


def register_cityscapes(name: str, image_dir: str, gt_dir: str, task: str = "instance") -> None:
    """Register ``name`` lazily: the instance records with the
    ``cityscapes_instance`` evaluator type, or (any other ``task``) the
    semantic ones with ``cityscapes_sem_seg``."""
    if task == "instance":
        DatasetCatalog.register(name, lambda: load_cityscapes_instances(image_dir, gt_dir))
        MetadataCatalog.get(name).set(
            thing_classes=[n for n, _ in CITYSCAPES_THING_CLASSES],
            image_dir=image_dir, gt_dir=gt_dir, evaluator_type="cityscapes_instance",
        )
    else:
        DatasetCatalog.register(name, lambda: load_cityscapes_semantic(image_dir, gt_dir))
        MetadataCatalog.get(name).set(
            stuff_classes=list(CITYSCAPES_SEM_SEG_CLASSES),
            image_dir=image_dir, gt_dir=gt_dir, ignore_label=255,
            evaluator_type="cityscapes_sem_seg",
        )
