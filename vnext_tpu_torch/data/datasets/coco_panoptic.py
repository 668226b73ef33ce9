"""COCO panoptic: the panopticapi id encoding and the panoptic json loader.

Counterpart of ``vnext_tpu.data.datasets.coco_panoptic`` (reference surface:
detectron2/data/datasets/coco_panoptic.py register_coco_panoptic): one record
per annotation of the panoptic json, with the image's file name and size, the
id-map PNG's path (segment id = R + 256 G + 256^2 B) and the segments' info.
``register_coco_panoptic`` registers such a set with the
``coco_panoptic_seg`` evaluator type; with ``instances_json`` and
``sem_seg_root`` each record also carries the image's instance annotations
and its semantic label PNG, as detectron2's "separated" sets do, so that the
set trains and the COCO and semantic evaluators score it (the JAX package's
records carry neither: ROADMAP Queue 3, item 6).
"""

from __future__ import annotations

import json
import logging
import os
from typing import List, Optional

import numpy as np

from ..catalog import DatasetCatalog, MetadataCatalog
from .coco import load_coco_json

logger = logging.getLogger("vnext_tpu_torch")


def rgb2id(color: np.ndarray) -> np.ndarray:
    """panopticapi encoding: segment id = R + 256 G + 256^2 B of an [H, W, 3]
    image; a map of another rank is returned as int64 ids."""
    color = color.astype(np.int64)
    if color.ndim == 3:
        return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]
    return color


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    """The inverse of ``rgb2id``: [H, W] ids -> [H, W, 3] uint8."""
    id_map = id_map.astype(np.int64)
    return np.stack([id_map % 256, (id_map // 256) % 256, (id_map // 256 ** 2) % 256], -1).astype(np.uint8)


def load_coco_panoptic_json(json_file: str, image_root: str, panoptic_root: str) -> List[dict]:
    """Records of the panoptic json's annotations: ``file_name`` (the image's,
    else the PNG's name as .jpg), ``image_id``, ``height``, ``width``,
    ``pan_seg_file_name`` and ``segments_info``."""
    with open(json_file) as f:
        data = json.load(f)
    records = []
    sizes = {im["id"]: im for im in data.get("images", [])}
    for ann in data["annotations"]:
        img = sizes.get(ann["image_id"], {})
        file_name = img.get("file_name", ann["file_name"].replace(".png", ".jpg"))
        records.append({
            "file_name": os.path.join(image_root, file_name),
            "image_id": ann["image_id"],
            "height": img.get("height"),
            "width": img.get("width"),
            "pan_seg_file_name": os.path.join(panoptic_root, ann["file_name"]),
            "segments_info": ann["segments_info"],
        })
    logger.info("Loaded %d panoptic records from %s", len(records), json_file)
    return records


def _separated_records(name: str, panoptic_json: str, image_root: str, panoptic_root: str, instances_json: str,
                       sem_seg_root: str) -> List[dict]:
    """The panoptic records, each with its image's instance ``annotations``
    (``load_coco_json``'s for the dataset ``name``: contiguous category ids)
    and ``sem_seg_file_name`` (the PNG of the panoptic one's name under
    ``sem_seg_root``)."""
    annotations = {r["image_id"]: r["annotations"] for r in load_coco_json(instances_json, image_root, name)}
    records = load_coco_panoptic_json(panoptic_json, image_root, panoptic_root)
    for r in records:
        r["annotations"] = annotations.get(r["image_id"], [])
        r["sem_seg_file_name"] = os.path.join(sem_seg_root, os.path.basename(r["pan_seg_file_name"]))
    return records


def register_coco_panoptic(name: str, metadata: dict, image_root: str, panoptic_root: str, panoptic_json: str,
                           instances_json: Optional[str] = None, sem_seg_root: Optional[str] = None) -> None:
    """Register ``name`` to load ``panoptic_json`` lazily, with ``metadata`` and
    the ``coco_panoptic_seg`` evaluator type. Given both ``instances_json``
    (then the COCO evaluator's ``json_file``) and ``sem_seg_root``, the
    records are the "separated" ones."""
    if (instances_json is None) != (sem_seg_root is None):
        raise ValueError("register_coco_panoptic: give both instances_json and sem_seg_root, or neither")
    if instances_json is None:
        DatasetCatalog.register(name, lambda: load_coco_panoptic_json(panoptic_json, image_root, panoptic_root))
    else:
        DatasetCatalog.register(name, lambda: _separated_records(name, panoptic_json, image_root, panoptic_root,
                                                                 instances_json, sem_seg_root))
        metadata = dict(metadata, json_file=instances_json, sem_seg_root=sem_seg_root)
    MetadataCatalog.get(name).set(panoptic_root=panoptic_root, image_root=image_root, panoptic_json=panoptic_json,
                                  evaluator_type="coco_panoptic_seg", **metadata)
