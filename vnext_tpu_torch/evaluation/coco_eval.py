"""COCO-style image instance evaluation: box, mask and keypoint AP.

Counterpart of ``vnext_tpu.evaluation.coco_eval`` (reference surface:
detectron2/evaluation/coco_evaluation.py COCOEvaluator): per-image detections
become COCO json results, written as ``coco_instances_results.json``, and are
scored by the video evaluator's accumulation (``ytvos_eval.YTVOSeval``) with
every image a 1-frame video, at COCO's image area ranges (32² and 96²). Box AP
compares boxes rasterized to RLE masks at the image's size, as the JAX package
does (a kept divergence from pycocotools' exact box IoU, ROADMAP Queue 3). The
``keypoints`` task matches by object keypoint similarity (pycocotools'
computeOks, COCO's 17 sigmas) at 20 detections an image, over the all /
medium / large area bins, ground truths with no labeled keypoint ignored.
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
from .ytvis_eval import DatasetEvaluator
from .ytvos_eval import YTVOSeval

logger = logging.getLogger("vnext_tpu_torch")

# COCO's image area ranges (pycocotools Params), not the video tube ranges YTVOSeval defaults to
COCO_AREA_RANGES = {"all": [0, 1e10], "small": [0, 32 ** 2], "medium": [32 ** 2, 96 ** 2], "large": [96 ** 2, 1e10]}


# COCO's 17-keypoint OKS sigmas (pycocotools cocoeval.py computeOks)
KPT_OKS_SIGMAS = np.array([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87,
                           0.89, 0.89]) / 10.0
KPT_AREA_RANGES = {"all": [0, 1e10], "medium": [32 ** 2, 96 ** 2], "large": [96 ** 2, 1e10]}


def compute_oks_matrix(dt_anns, gt_anns, sigmas=KPT_OKS_SIGMAS) -> np.ndarray:
    """[D, G] object keypoint similarity (pycocotools computeOks): a gaussian
    falloff per visible ground-truth keypoint, scaled by its sigma and the
    ground truth's area; a ground truth with no labeled keypoint measures the
    distance outside its box grown by its size on each side."""
    kvars = (sigmas * 2.0) ** 2
    oks = np.zeros((len(dt_anns), len(gt_anns)))
    for gi, gt in enumerate(gt_anns):
        g = np.asarray(gt["keypoints"], np.float64).reshape(-1)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int((vg > 0).sum())
        x, y, bw, bh = gt["bbox"]
        x0, x1, y0, y1 = x - bw, x + 2 * bw, y - bh, y + 2 * bh
        area = float(gt.get("area", bw * bh))
        for di, dt in enumerate(dt_anns):
            d = np.asarray(dt["keypoints"], np.float64).reshape(-1)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                dx = np.maximum(0.0, x0 - xd) + np.maximum(0.0, xd - x1)
                dy = np.maximum(0.0, y0 - yd) + np.maximum(0.0, yd - y1)
            e = (dx ** 2 + dy ** 2) / kvars / (area + np.spacing(1)) / 2.0
            if k1 > 0:
                e = e[vg > 0]
            oks[di, gi] = float(np.sum(np.exp(-e)) / e.shape[0]) if e.shape[0] else 0.0
    return oks


def _kp_extent_area(kps) -> float:
    """A keypoint detection's area: its keypoints' extent (pycocotools loadRes)."""
    k = np.asarray(kps, np.float64).reshape(-1)
    xs, ys = k[0::3], k[1::3]
    return float((xs.max() - xs.min()) * (ys.max() - ys.min()))


def _box_to_rle(box, h, w):
    m = np.zeros((h, w), bool)
    x1, y1, x2, y2 = [int(round(v)) for v in box]
    m[max(y1, 0): max(y2, 0), max(x1, 0): max(x2, 0)] = True
    return rle_encode(m)


def _xywh_rle(bbox, h, w):
    x, y, bw, bh = bbox
    return _box_to_rle([x, y, x + bw, y + bh], h, w)


class COCOEvaluator(DatasetEvaluator):
    """Evaluates 'bbox', 'segm' and 'keypoints' AP on COCO-format image datasets."""

    def __init__(self, dataset_name: str, tasks=("bbox",), output_dir: Optional[str] = None):
        self._dataset_name = dataset_name
        self._tasks = tuple(tasks)
        self._output_dir = output_dir
        self._metadata = MetadataCatalog.get(dataset_name)
        id_map = self._metadata.get("thing_dataset_id_to_contiguous_id")
        self._reverse_id_map = {v: k for k, v in id_map.items()} if id_map else None
        self._predictions: List[dict] = []

    def reset(self):
        self._predictions = []

    def process(self, inputs: List[dict], outputs: List[dict]):
        """outputs: per image {boxes [N, 4] xyxy, scores [N], classes [N],
        valid [N] (optional), masks [N, H, W] (optional), keypoints [N, K, 3]
        (optional)}, numpy."""
        for record, output in zip(inputs, outputs):
            boxes = np.asarray(output["boxes"])
            scores = np.asarray(output["scores"])
            classes = np.asarray(output["classes"])
            valid = np.asarray(output.get("valid", scores > 0))
            masks, kps = output.get("masks"), output.get("keypoints")
            for i in np.flatnonzero(valid):
                cat = self._reverse_id_map[int(classes[i])] if self._reverse_id_map else int(classes[i]) + 1
                entry = {
                    "image_id": record["image_id"], "category_id": cat, "score": float(scores[i]),
                    "bbox": [float(boxes[i, 0]), float(boxes[i, 1]), float(boxes[i, 2] - boxes[i, 0]),
                             float(boxes[i, 3] - boxes[i, 1])],
                }
                if masks is not None:
                    entry["segmentation"] = rle_encode(np.asarray(masks[i], bool))
                if kps is not None:
                    entry["keypoints"] = np.asarray(kps[i], np.float64).reshape(-1).tolist()
                self._predictions.append(entry)

    def evaluate(self) -> Optional[Dict[str, Dict[str, float]]]:
        """Gathers every process's predictions; on the main process writes the
        results json under the output directory and returns {task: stats}, or
        {} where the dataset has no ground-truth json; None on the others."""
        chunks = process_allgather(self._predictions)
        if not is_main_process():
            return None
        predictions = [p for c in chunks for p in c]
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            path = os.path.join(self._output_dir, "coco_instances_results.json")
            with open(path, "w") as f:
                json.dump(predictions, f)
            logger.info("COCO results written to %s (%d predictions)", path, len(predictions))
        json_file = self._metadata.get("json_file")
        if not json_file or not os.path.exists(json_file):
            logger.info("No GT json for %s; results written only", self._dataset_name)
            return {}
        with open(json_file) as f:
            gt = json.load(f)
        return self._evaluate_predictions(gt, predictions)

    def _evaluate_predictions(self, gt: dict, predictions: List[dict]) -> Dict[str, Dict[str, float]]:
        sizes = {im["id"]: (im["height"], im["width"]) for im in gt["images"]}
        videos = [{"id": im["id"], "height": im["height"], "width": im["width"], "length": 1,
                   "file_names": [im.get("file_name", "")]} for im in gt["images"]]
        anns = gt.get("annotations", []) or []

        def gt_entry(ann, rle):
            return {"id": ann["id"], "video_id": ann["image_id"], "category_id": ann["category_id"],
                    "segmentations": [rle], "iscrowd": ann.get("iscrowd", 0)}

        def mask_rle(ann):
            h, w = sizes[ann["image_id"]]
            segm = ann.get("segmentation")
            if isinstance(segm, list) and segm:
                return rle_encode(polygons_to_bitmask([np.asarray(p) for p in segm], h, w))
            if isinstance(segm, dict):
                return segm
            return _xywh_rle(ann["bbox"], h, w)

        results = {}
        for task in self._tasks:
            if task == "keypoints":
                results[task] = self._evaluate_keypoints(gt, videos, predictions)
                logger.info("COCO %s eval: %s", task, results[task])
                continue
            dets = []
            for p in predictions:
                seg = (p["segmentation"] if task == "segm" and "segmentation" in p
                       else _xywh_rle(p["bbox"], *sizes[p["image_id"]]))
                dets.append({"video_id": p["image_id"], "category_id": p["category_id"], "score": p["score"],
                             "segmentations": [seg]})
            # bbox: box-rasterized ground truth against box-rasterized detections
            gt_task = {"videos": videos, "categories": gt.get("categories", []), "annotations": [
                gt_entry(a, _xywh_rle(a["bbox"], *sizes[a["image_id"]]) if task == "bbox" else mask_rle(a))
                for a in anns]}
            results[task] = YTVOSeval(gt_task, dets, area_ranges=COCO_AREA_RANGES).evaluate()
            logger.info("COCO %s eval: %s", task, results[task])
        return results

    def _evaluate_keypoints(self, gt: dict, videos: List[dict], predictions: List[dict]) -> Dict[str, float]:
        """OKS-matched keypoint AP (pycocotools Params(iouType='keypoints'):
        maxDets [20], the all / medium / large bins, ground truths with no
        labeled keypoint ignored)."""
        anns = []
        for ann in gt.get("annotations", []) or []:
            if "keypoints" not in ann:
                continue
            vis = np.asarray(ann["keypoints"][2::3])
            _, _, bw, bh = ann["bbox"]
            anns.append({"id": ann["id"], "video_id": ann["image_id"], "category_id": ann["category_id"],
                         "keypoints": ann["keypoints"], "bbox": ann["bbox"], "area": float(ann.get("area", bw * bh)),
                         "iscrowd": ann.get("iscrowd", 0),
                         "ignore": int(ann.get("num_keypoints", int((vis > 0).sum())) == 0), "segmentations": [None]})
        dets = [{"video_id": p["image_id"], "category_id": p["category_id"], "score": p["score"],
                 "keypoints": p["keypoints"], "area": _kp_extent_area(p["keypoints"]), "segmentations": [None]}
                for p in predictions if "keypoints" in p]
        gt_kp = {"videos": videos, "categories": gt.get("categories", []), "annotations": anns}
        return YTVOSeval(gt_kp, dets, max_dets=(20,), area_ranges=KPT_AREA_RANGES, iou_fn=compute_oks_matrix,
                         area_fn=lambda a: float(a["area"])).evaluate()
