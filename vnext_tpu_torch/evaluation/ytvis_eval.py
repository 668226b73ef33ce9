"""YouTube-VIS evaluator: collect each video's predictions, write
``results.json``, and score them with the tube-IoU mAP where the dataset's
json has ground truth.

Counterpart of ``vnext_tpu.evaluation.ytvis_eval`` (``DatasetEvaluator``,
``YTVISEvaluator``, ``_normalize_gt``, ``build_evaluator``) for the ``ytvis``
evaluator type; ``build_evaluator`` also makes ``coco_eval.COCOEvaluator``
for the ``coco`` type. One process evaluates everything: the gather across processes
waits for the port's distribution (ROADMAP Queue 1, item 12).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np

from ..data.catalog import MetadataCatalog
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
    def __init__(self, dataset_name: str, output_dir: Optional[str] = None):
        self._dataset_name = dataset_name
        self._output_dir = output_dir
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

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        """Writes ``results.json`` under the output directory; returns
        ``{"segm": stats}``, or {} where there is no ground truth to score."""
        predictions = self._predictions
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            path = os.path.join(self._output_dir, "results.json")
            with open(path, "w") as f:
                json.dump(predictions, f)
            logger.info("YTVIS results written to %s (%d predictions)", path, len(predictions))

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
    video AP) or "coco" (``COCOEvaluator``, "bbox" and with ``MODEL.MASK_ON``
    "segm"); the other types come with the rest of the Detectron2 families
    (ROADMAP Queue 1, items 11d and 11e)."""
    evaluator_type = MetadataCatalog.get(dataset_name).get("evaluator_type", "ytvis")
    output_dir = output_dir or cfg.OUTPUT_DIR
    if evaluator_type == "ytvis":
        return YTVISEvaluator(dataset_name, output_dir)
    if evaluator_type == "coco":
        from .coco_eval import COCOEvaluator

        tasks = ("bbox", "segm") if cfg.MODEL.MASK_ON else ("bbox",)
        if cfg.MODEL.KEYPOINT_ON:
            tasks += ("keypoints",)
        return COCOEvaluator(dataset_name, tasks=tasks, output_dir=output_dir)
    raise NotImplementedError(
        f"no evaluator for type {evaluator_type!r} (dataset {dataset_name}): the port has the 'ytvis' and "
        "'coco' evaluators; the others come with the rest of the Detectron2 families (ROADMAP Queue 1, "
        "items 11d and 11e)")
