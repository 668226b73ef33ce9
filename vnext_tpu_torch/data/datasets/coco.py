"""COCO instances: the json loader and the builtin splits' registration.

Counterpart of ``vnext_tpu.data.datasets.coco`` (detectron2's
``load_coco_json`` surface, parsed straight from the json without
pycocotools): one record per image, sorted by image id, with the category ids
mapped to contiguous ones when a dataset name is given, polygons of fewer than
3 points (or of an odd length) dropped and an annotation left with none
skipped, and integer keypoint coordinates shifted by 0.5 into box coordinates.
``register_all_coco`` registers the 2017 splits under ``VNEXT_DATASETS``
(default ``datasets``), as the JAX package does.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog
from .builtin_meta import get_keypoint_metadata

logger = logging.getLogger("vnext_tpu_torch")


def load_coco_json(
    json_file: str, image_root: str, dataset_name: Optional[str] = None
) -> List[dict]:
    """The json's images as records (``file_name``, ``height``, ``width``,
    ``image_id``, ``annotations``: ``iscrowd``, ``id``, ``category_id``, an
    XYWH ``bbox``, ``segmentation``, and ``keypoints`` where the json has
    them). With ``dataset_name``, the dataset's metadata gets its
    ``thing_classes`` and the id map, and category ids become contiguous."""
    with open(json_file) as f:
        data = json.load(f)

    id_map = None
    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        cats = sorted(data.get("categories", []), key=lambda c: c["id"])
        if cats:
            meta.thing_classes = [c["name"] for c in cats]
            id_map = {c["id"]: i for i, c in enumerate(cats)}
            meta.thing_dataset_id_to_contiguous_id = id_map

    anns_by_image: Dict[int, List[dict]] = {}
    for ann in data.get("annotations", []) or []:
        anns_by_image.setdefault(ann["image_id"], []).append(ann)

    records = []
    for img in sorted(data["images"], key=lambda im: im["id"]):
        objs = []
        for ann in anns_by_image.get(img["id"], []):
            segm = ann.get("segmentation")
            if isinstance(segm, list):
                segm = [p for p in segm if len(p) % 2 == 0 and len(p) >= 6]
                if not segm:
                    continue
            obj = {
                "iscrowd": ann.get("iscrowd", 0),
                "id": ann["id"],
                "category_id": id_map[ann["category_id"]] if id_map else ann["category_id"],
                "bbox": ann["bbox"],  # XYWH_ABS
                "segmentation": segm,
            }
            keypts = ann.get("keypoints")
            if keypts:
                # reference load_coco_json keypoint convention: shift integer
                # pixel-index coords by 0.5 to box-coordinate space (coco.py:238)
                keypts = [
                    v + 0.5 if i % 3 != 2 and isinstance(v, int) else v
                    for i, v in enumerate(keypts)
                ]
                obj["keypoints"] = keypts
                obj["num_keypoints"] = ann.get("num_keypoints", sum(1 for v in keypts[2::3] if v > 0))
            objs.append(obj)
        records.append(
            {
                "file_name": os.path.join(image_root, img["file_name"]),
                "height": img["height"],
                "width": img["width"],
                "image_id": img["id"],
                "annotations": objs,
            }
        )
    logger.info("Loaded %d images from %s", len(records), json_file)
    return records


def register_coco_instances(name: str, metadata: dict, json_file: str, image_root: str) -> None:
    """Register ``name`` to load ``json_file`` lazily, with ``metadata``."""
    DatasetCatalog.register(name, lambda: load_coco_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type="coco", **metadata
    )


_PREDEFINED_COCO = {
    "coco_2017_train": ("coco/train2017", "coco/annotations/instances_train2017.json"),
    "coco_2017_val": ("coco/val2017", "coco/annotations/instances_val2017.json"),
    "keypoints_coco_2017_train": (
        "coco/train2017", "coco/annotations/person_keypoints_train2017.json",
    ),
    "keypoints_coco_2017_val": (
        "coco/val2017", "coco/annotations/person_keypoints_val2017.json",
    ),
}


def register_all_coco(root: Optional[str] = None) -> None:
    """Register the COCO 2017 instance and person-keypoint splits under ``root``
    (default ``$VNEXT_DATASETS`` or ``datasets``); names already registered stay."""
    root = root or os.environ.get("VNEXT_DATASETS", "datasets")
    for name, (image_dir, json_path) in _PREDEFINED_COCO.items():
        if name in DatasetCatalog:
            continue
        metadata = get_keypoint_metadata() if name.startswith("keypoints_") else {}
        register_coco_instances(
            name, metadata, os.path.join(root, json_path), os.path.join(root, image_dir)
        )
