"""YouTube-VIS / OVIS dataset loading and registration.

Counterpart of ``vnext_tpu.data.datasets.ytvis``: the json is parsed directly
(no pycocotools) into the record format the mapper, the test loader and the
evaluator read:

    {"file_names": [...], "height", "width", "length", "video_id",
     "annotations": [frame_objs...]}   # per frame: list of
        {"category_id" (contiguous), "id", "iscrowd", "bbox" (XYWH_ABS),
         "segmentation" (polygons or RLE dict)}

The category name tables are the public datasets' constants (YouTube-VIS 2019
and 2021, OVIS).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog

logger = logging.getLogger("vnext_tpu_torch")

YTVIS_2019_CLASSES = [
    "person", "giant_panda", "lizard", "parrot", "skateboard", "sedan", "ape",
    "dog", "snake", "monkey", "hand", "rabbit", "duck", "cat", "cow", "fish",
    "train", "horse", "turtle", "bear", "motorbike", "giraffe", "leopard",
    "fox", "deer", "owl", "surfboard", "airplane", "truck", "zebra", "tiger",
    "elephant", "snowboard", "boat", "shark", "mouse", "frog", "eagle",
    "earless_seal", "tennis_racket",
]

YTVIS_2021_CLASSES = [
    "airplane", "bear", "bird", "boat", "car", "cat", "cow", "deer", "dog",
    "duck", "earless_seal", "elephant", "fish", "flying_disc", "fox", "frog",
    "giant_panda", "giraffe", "horse", "leopard", "lizard", "monkey",
    "motorbike", "mouse", "parrot", "person", "rabbit", "shark", "skateboard",
    "snake", "snowboard", "squirrel", "surfboard", "tennis_racket", "tiger",
    "train", "truck", "turtle", "whale", "zebra",
]

OVIS_CLASSES = [
    "Person", "Bird", "Cat", "Dog", "Horse", "Sheep", "Cow", "Elephant",
    "Bear", "Zebra", "Giraffe", "Poultry", "Giant_panda", "Lizard", "Parrot",
    "Monkey", "Rabbit", "Tiger", "Fish", "Turtle", "Bicycle", "Motorcycle",
    "Airplane", "Boat", "Vehical",
]


def load_ytvis_json(
    json_file: str, image_root: str, dataset_name: Optional[str] = None
) -> List[dict]:
    """Parse a YTVIS-format json into the record format above."""
    with open(json_file, "r") as f:
        data = json.load(f)

    id_map = None
    if dataset_name is not None:
        meta = MetadataCatalog.get(dataset_name)
        cats = sorted(data.get("categories", []), key=lambda c: c["id"])
        cat_ids = [c["id"] for c in cats]
        if cats:
            meta.thing_classes = [c["name"] for c in cats]
            id_map = {v: i for i, v in enumerate(cat_ids)}
            meta.thing_dataset_id_to_contiguous_id = id_map

    anns_by_video: Dict[int, List[dict]] = {}
    for ann in data.get("annotations", []) or []:
        anns_by_video.setdefault(ann["video_id"], []).append(ann)

    num_invalid_segm = 0
    dataset_dicts = []
    for vid in sorted(data["videos"], key=lambda v: v["id"]):
        record = {
            "file_names": [os.path.join(image_root, fn) for fn in vid["file_names"]],
            "height": vid["height"],
            "width": vid["width"],
            "length": vid["length"],
            "video_id": vid["id"],
        }
        video_objs = []
        for frame_idx in range(record["length"]):
            frame_objs = []
            for ann in anns_by_video.get(vid["id"], []):
                bboxes = ann.get("bboxes")
                segms = ann.get("segmentations")
                if not (bboxes and segms and bboxes[frame_idx] and segms[frame_idx]):
                    continue
                segm = segms[frame_idx]
                if isinstance(segm, list):
                    segm = [p for p in segm if len(p) % 2 == 0 and len(p) >= 6]
                    if not segm:
                        num_invalid_segm += 1
                        continue
                obj = {
                    "iscrowd": ann.get("iscrowd", 0),
                    "id": ann["id"],
                    "category_id": id_map[ann["category_id"]] if id_map else ann["category_id"],
                    "bbox": bboxes[frame_idx],  # XYWH_ABS
                    "segmentation": segm,
                }
                frame_objs.append(obj)
            video_objs.append(frame_objs)
        record["annotations"] = video_objs
        dataset_dicts.append(record)

    if num_invalid_segm:
        logger.warning("Filtered out %d instances without valid segmentation", num_invalid_segm)
    logger.info("Loaded %d videos from %s", len(dataset_dicts), json_file)
    return dataset_dicts


def register_ytvis_instances(name: str, metadata: dict, json_file: str, image_root: str) -> None:
    """Register one YTVIS-format dataset: its loader, and metadata with ``evaluator_type`` "ytvis"."""
    DatasetCatalog.register(name, lambda: load_ytvis_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type="ytvis", **metadata
    )


_PREDEFINED_YTVIS = {
    "ytvis_2019_train": ("ytvis_2019/train/JPEGImages", "ytvis_2019/annotations/instances_train_sub.json", YTVIS_2019_CLASSES),
    "ytvis_2019_val": ("ytvis_2019/valid/JPEGImages", "ytvis_2019/annotations/instances_val_sub.json", YTVIS_2019_CLASSES),
    "ytvis_2019_test": ("ytvis_2019/test/JPEGImages", "ytvis_2019/test.json", YTVIS_2019_CLASSES),
    "ytvis_2021_train": ("ytvis_2021/train/JPEGImages", "ytvis_2021/annotations/instances_train_sub.json", YTVIS_2021_CLASSES),
    "ytvis_2021_val": ("ytvis_2021/valid/JPEGImages", "ytvis_2021/annotations/instances_val_sub.json", YTVIS_2021_CLASSES),
    "ovis_train": ("ovis/train", "ovis/annotations_train.json", OVIS_CLASSES),
    "ovis_val": ("ovis/valid", "ovis/annotations_valid.json", OVIS_CLASSES),
}


def register_all_ytvis(root: Optional[str] = None) -> None:
    """Register the builtin YTVIS/OVIS datasets under $VNEXT_DATASETS (default ./datasets)."""
    root = root or os.environ.get("VNEXT_DATASETS", "datasets")
    for name, (image_dir, json_path, classes) in _PREDEFINED_YTVIS.items():
        if name in DatasetCatalog:
            continue
        register_ytvis_instances(
            name,
            {"thing_classes": classes},
            os.path.join(root, json_path),
            os.path.join(root, image_dir),
        )
