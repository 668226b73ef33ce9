"""YouTube-VIS evaluator: collect each video's predictions, write
``results.json``, and score them with the tube-IoU mAP where the dataset's
json has ground truth.

Counterpart of ``vnext_tpu.evaluation.ytvis_eval`` (``DatasetEvaluator``,
``YTVISEvaluator``, ``_normalize_gt``, ``build_evaluator``) for the ``ytvis``
evaluator type; ``build_evaluator`` also makes the evaluators of the
``coco``, ``coco_panoptic_seg``, ``sem_seg``, ``lvis``, ``pascal_voc``,
``cityscapes_instance`` and ``cityscapes_sem_seg`` types. Every process's
predictions are gathered to the main process (``parallel.process_allgather``),
which alone writes and scores them; the others' ``evaluate`` returns None.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np

from ..data.catalog import MetadataCatalog
from ..parallel.mesh import is_main_process, process_allgather
from ..structures.masks import polygons_to_bitmask
from .rle import rle_encode
from .ytvis_json import video_output_to_json
from .ytvos_eval import YTVOSeval

logger = logging.getLogger("vnext_tpu_torch")


class DatasetEvaluator:
    """Evaluator protocol: ``reset``, then ``process`` per batch, then ``evaluate``."""

    def reset(self):
        pass

    def process(self, inputs, outputs):
        pass

    def evaluate(self):
        pass


class YTVISEvaluator(DatasetEvaluator):
    """``results.json`` of every video's tracks, and the tube-IoU AP where the
    dataset's json has ground truth and ``local_eval`` is set (without it,
    the file alone, for the test server)."""

    def __init__(self, dataset_name: str, output_dir: Optional[str] = None, local_eval: bool = True):
        self._dataset_name = dataset_name
        self._output_dir = output_dir
        self._local_eval = local_eval
        self._metadata = MetadataCatalog.get(dataset_name)
        self._reverse_id_map = None
        id_map = self._metadata.get("thing_dataset_id_to_contiguous_id")
        if id_map:
            self._reverse_id_map = {v: k for k, v in id_map.items()}
        self._predictions: List[dict] = []

    def reset(self):
        self._predictions = []

    def process(self, inputs: List[dict], outputs: List[dict]):
        """inputs: video records; outputs: the video runner's output dicts."""
        for record, output in zip(inputs, outputs):
            self._predictions.extend(
                video_output_to_json(
                    output,
                    video_id=record["video_id"],
                    height=record["height"],
                    width=record["width"],
                    reverse_id_map=self._reverse_id_map,
                )
            )

    def evaluate(self) -> Optional[Dict[str, Dict[str, float]]]:
        """Writes ``results.json`` under the output directory; returns
        ``{"segm": stats}``, or {} where there is no ground truth to score or
        ``local_eval`` is off; None on a process other than the main one."""
        chunks = process_allgather(self._predictions)
        if not is_main_process():
            return None
        predictions = [p for c in chunks for p in c]
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            path = os.path.join(self._output_dir, "results.json")
            with open(path, "w") as f:
                json.dump(predictions, f)
            logger.info("YTVIS results written to %s (%d predictions)", path, len(predictions))
        if not self._local_eval:
            return {}

        json_file = self._metadata.get("json_file")
        if not json_file or not os.path.exists(json_file):
            logger.info("No GT json for %s; skipping local mAP", self._dataset_name)
            return {}
        with open(json_file) as f:
            gt = json.load(f)
        if not gt.get("annotations"):
            logger.info("GT json has no annotations (test server split); skipping local mAP")
            return {}
        stats = YTVOSeval(_normalize_gt(gt), predictions).evaluate()
        logger.info("YTVIS local eval: %s", stats)
        return {"segm": stats}


def _normalize_gt(gt: dict) -> dict:
    """Rasterize polygon ground-truth segmentations to RLE, so that the tube IoU
    reads every mask alike. Changes ``gt`` in place and returns it."""
    h_by_vid = {v["id"]: (v["height"], v["width"]) for v in gt["videos"]}
    for ann in gt.get("annotations", []) or []:
        h, w = h_by_vid[ann["video_id"]]
        fixed = []
        for segm in ann["segmentations"]:
            if segm is None or isinstance(segm, dict):
                fixed.append(segm)
            else:
                fixed.append(rle_encode(polygons_to_bitmask([np.asarray(p) for p in segm], h, w)))
        ann["segmentations"] = fixed
    return gt


def build_evaluator(cfg, dataset_name: str, output_dir: Optional[str] = None) -> DatasetEvaluator:
    """The evaluator of the dataset's ``evaluator_type`` metadata: "ytvis" (the
    video AP); "coco" (``COCOEvaluator``, "bbox" and with ``MODEL.MASK_ON``
    "segm", with ``MODEL.KEYPOINT_ON`` "keypoints"); "coco_panoptic_seg" (that
    and ``COCOPanopticEvaluator`` with the id map's contiguous ids as things,
    combined by ``DatasetEvaluators``); "sem_seg" (``SemSegEvaluator`` over the
    dataset's ``stuff_classes``, else ``MODEL.SEM_SEG_HEAD.NUM_CLASSES``, and
    its ``ignore_label``, default 255); "lvis" (``LVISEvaluator``, "bbox" and
    with ``MODEL.MASK_ON`` "segm"); "pascal_voc"
    (``PascalVOCDetectionEvaluator`` over the ``thing_classes``, VOC07's
    11-point AP when the dataset's ``year`` is 2007); "cityscapes_instance"
    and "cityscapes_sem_seg"; "rotated_coco" (``RotatedCOCOEvaluator`` over
    the ``thing_classes``)."""
    meta = MetadataCatalog.get(dataset_name)
    evaluator_type = meta.get("evaluator_type", "ytvis")
    output_dir = output_dir or cfg.OUTPUT_DIR
    if evaluator_type == "ytvis":
        return YTVISEvaluator(dataset_name, output_dir)
    if evaluator_type in ("coco", "coco_panoptic_seg"):
        from .coco_eval import COCOEvaluator

        tasks = ("bbox", "segm") if cfg.MODEL.MASK_ON else ("bbox",)
        if cfg.MODEL.KEYPOINT_ON:
            tasks += ("keypoints",)
        coco = COCOEvaluator(dataset_name, tasks=tasks, output_dir=output_dir)
        if evaluator_type == "coco":
            return coco
        from .evaluator import DatasetEvaluators
        from .panoptic_eval import COCOPanopticEvaluator

        thing_ids = set((meta.get("thing_dataset_id_to_contiguous_id") or {}).values()) or None
        return DatasetEvaluators([coco, COCOPanopticEvaluator(thing_ids=thing_ids)])
    if evaluator_type == "sem_seg":
        from .sem_seg_eval import SemSegEvaluator

        return SemSegEvaluator(num_classes=len(meta.get("stuff_classes") or []) or cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES,
                               ignore_label=meta.get("ignore_label", 255))
    if evaluator_type == "lvis":
        from .lvis_eval import LVISEvaluator

        return LVISEvaluator(dataset_name, tasks=("bbox", "segm") if cfg.MODEL.MASK_ON else ("bbox",),
                             output_dir=output_dir)
    if evaluator_type == "pascal_voc":
        from .pascal_voc_eval import PascalVOCDetectionEvaluator

        return PascalVOCDetectionEvaluator(class_names=list(meta.get("thing_classes") or []),
                                           use_07_metric=meta.get("year", 2007) == 2007)
    if evaluator_type == "cityscapes_instance":
        from .cityscapes_eval import CityscapesInstanceEvaluator

        return CityscapesInstanceEvaluator(class_names=meta.get("thing_classes"))
    if evaluator_type == "cityscapes_sem_seg":
        from .cityscapes_eval import CityscapesSemSegEvaluator

        return CityscapesSemSegEvaluator(class_names=meta.get("stuff_classes"))
    if evaluator_type == "rotated_coco":
        from .rotated_coco_eval import RotatedCOCOEvaluator

        return RotatedCOCOEvaluator(class_names=meta.get("thing_classes"))
    raise NotImplementedError(f"no evaluator for type {evaluator_type!r} (dataset {dataset_name})")
