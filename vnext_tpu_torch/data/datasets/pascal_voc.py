"""Pascal VOC detection: the XML loader and a split's registration.

Counterpart of ``vnext_tpu.data.datasets.pascal_voc`` (reference surface:
detectron2/data/datasets/pascal_voc.py): the image ids of a split's
``ImageSets/Main/<split>.txt``, each parsed from ``Annotations/<id>.xml``,
the 20 classes' contiguous ids, ``difficult`` flags, and boxes moved from
VOC's 1-based inclusive pixels to 0-based XYXY by shifting their first corner
by one. Each annotation says ``"bbox_mode": BoxMode.XYXY_ABS``: the JAX
package's records say nothing, so its mapper reads these boxes as XYWH
(ROADMAP Queue 3, item 7); the port's mapper reads the mode.
"""

from __future__ import annotations

import logging
import os
import xml.etree.ElementTree as ET
from typing import List

from ...structures.boxes import BoxMode
from ..catalog import DatasetCatalog, MetadataCatalog

logger = logging.getLogger("vnext_tpu_torch")

CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def load_voc_instances(dirname: str, split: str, class_names=CLASS_NAMES) -> List[dict]:
    """Records of ``dirname``'s ``split`` (``dirname`` holds ``Annotations/``,
    ``ImageSets/Main/`` and ``JPEGImages/``); objects of other classes are
    left out."""
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        fileids = [line.strip() for line in f if line.strip()]
    name_to_id = {n: i for i, n in enumerate(class_names)}

    records = []
    for fileid in fileids:
        tree = ET.parse(os.path.join(dirname, "Annotations", fileid + ".xml"))
        size = tree.find("size")
        record = {
            "file_name": os.path.join(dirname, "JPEGImages", fileid + ".jpg"),
            "image_id": fileid,
            "height": int(size.find("height").text),
            "width": int(size.find("width").text),
        }
        objs = []
        for obj in tree.findall("object"):
            cls = obj.find("name").text
            if cls not in name_to_id:
                continue
            bb = obj.find("bndbox")
            box = [float(bb.find(k).text) for k in ("xmin", "ymin", "xmax", "ymax")]
            box[0] -= 1.0
            box[1] -= 1.0
            diff_node = obj.find("difficult")
            objs.append({
                "category_id": name_to_id[cls],
                "bbox": box,
                "bbox_mode": BoxMode.XYXY_ABS,
                "difficult": bool(int(diff_node.text)) if diff_node is not None else False,
                "iscrowd": 0,
            })
        record["annotations"] = objs
        records.append(record)
    logger.info("Loaded %d VOC images from %s/%s", len(records), dirname, split)
    return records


def register_pascal_voc(name: str, dirname: str, split: str, year: int = 2012) -> None:
    """Register ``name`` to load ``dirname``'s ``split`` lazily, with the
    ``pascal_voc`` evaluator type (VOC07's 11-point AP when ``year`` is 2007)."""
    DatasetCatalog.register(name, lambda: load_voc_instances(dirname, split))
    MetadataCatalog.get(name).set(
        thing_classes=list(CLASS_NAMES), dirname=dirname, year=year, split=split,
        evaluator_type="pascal_voc",
    )
