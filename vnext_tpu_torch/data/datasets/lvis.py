"""LVIS instances: the json loader and a split's registration.

Counterpart of ``vnext_tpu.data.datasets.lvis`` (reference surface:
detectron2/data/datasets/lvis.py): LVIS jsons are COCO-shaped, their images
named by ``coco_url`` (``.../val2017/000000000139.jpg`` -> ``val2017/...``
under the image root) where they have no ``file_name``, with each image's
``neg_category_ids`` and ``not_exhaustive_category_ids`` and each category's
``synonyms`` and ``frequency`` (r / c / f). With a dataset name, its metadata
gets the first synonyms as ``thing_classes``, the frequencies as
``class_frequencies`` and the contiguous id map. Boxes stay COCO's XYWH.
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog

logger = logging.getLogger("vnext_tpu_torch")


def load_lvis_json(json_file: str, image_root: str, dataset_name: Optional[str] = None) -> List[dict]:
    """The json's images as records, sorted by image id; polygons of an odd
    length or of fewer than 3 points are dropped (the annotation stays)."""
    with open(json_file) as f:
        data = json.load(f)

    id_map = None
    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        cats = sorted(data.get("categories", []), key=lambda c: c["id"])
        if cats:
            meta.thing_classes = [c.get("synonyms", [c.get("name", str(c["id"]))])[0] for c in cats]
            meta.class_frequencies = [c.get("frequency", "f") for c in cats]
            id_map = {c["id"]: i for i, c in enumerate(cats)}
            meta.thing_dataset_id_to_contiguous_id = id_map

    anns_by_image = {}
    for ann in data.get("annotations", []) or []:
        anns_by_image.setdefault(ann["image_id"], []).append(ann)

    records = []
    for img in sorted(data["images"], key=lambda im: im["id"]):
        file_name = img.get("file_name")
        if file_name is None and "coco_url" in img:
            file_name = "/".join(img["coco_url"].split("/")[-2:])
        objs = []
        for ann in anns_by_image.get(img["id"], []):
            segm = ann.get("segmentation")
            if isinstance(segm, list):
                segm = [p for p in segm if len(p) % 2 == 0 and len(p) >= 6]
            objs.append({
                "iscrowd": 0,
                "id": ann["id"],
                "category_id": id_map[ann["category_id"]] if id_map else ann["category_id"],
                "bbox": ann["bbox"],
                "segmentation": segm,
            })
        records.append({
            "file_name": os.path.join(image_root, file_name),
            "height": img["height"],
            "width": img["width"],
            "image_id": img["id"],
            "not_exhaustive_category_ids": img.get("not_exhaustive_category_ids", []),
            "neg_category_ids": img.get("neg_category_ids", []),
            "annotations": objs,
        })
    logger.info("Loaded %d LVIS images from %s", len(records), json_file)
    return records


def register_lvis_instances(name: str, metadata: dict, json_file: str, image_root: str) -> None:
    """Register ``name`` to load ``json_file`` lazily, with ``metadata`` and the
    ``lvis`` evaluator type."""
    DatasetCatalog.register(name, lambda: load_lvis_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(json_file=json_file, image_root=image_root, evaluator_type="lvis", **metadata)
