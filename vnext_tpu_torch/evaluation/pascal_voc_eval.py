"""Pascal VOC detection evaluation: AP50 by class.

Counterpart of ``vnext_tpu.evaluation.pascal_voc_eval`` (reference surface:
detectron2/evaluation/pascal_voc_evaluation.py): each class's detections,
by score, are matched greedily at IoU 0.5 (VOC's inclusive-pixel areas, the
+1) to the images' ground truth; a detection whose best match is a
``difficult`` object counts as neither a true nor a false positive, and
difficult objects are not in the recall's count. AP is VOC07's 11-point
interpolation or the area under the precision envelope (VOC10 and later).
Every process's detections and ground truth are gathered to the main
process, which alone scores them.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from ..parallel.mesh import is_main_process, process_allgather
from .ytvis_eval import DatasetEvaluator


def voc_ap(recall: np.ndarray, precision: np.ndarray, use_07_metric: bool = False) -> float:
    """AP of a precision / recall curve: 11-point (VOC07) or the exact area
    under the precision envelope."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval_class(gt_by_image: Dict, dets: List[dict], iou_thresh: float = 0.5,
                   use_07_metric: bool = False) -> Dict[str, float]:
    """One class's {"ap", "rec"}. ``gt_by_image``: image id -> {"boxes": [N, 4]
    XYXY, "difficult": [N] bool}; ``dets``: [{"image_id", "score", "box"}]."""
    matched = {k: np.zeros(len(v["boxes"]), bool) for k, v in gt_by_image.items()}
    npos = sum(int((~np.asarray(v["difficult"])).sum()) for v in gt_by_image.values())
    dets = sorted(dets, key=lambda d: -d["score"])
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, det in enumerate(dets):
        rec = gt_by_image.get(det["image_id"])
        best_iou, best_j = 0.0, -1
        if rec is not None and len(rec["boxes"]):
            g = np.asarray(rec["boxes"], np.float64)
            b = np.asarray(det["box"], np.float64)
            ix1 = np.maximum(g[:, 0], b[0])
            iy1 = np.maximum(g[:, 1], b[1])
            ix2 = np.minimum(g[:, 2], b[2])
            iy2 = np.minimum(g[:, 3], b[3])
            inter = np.maximum(ix2 - ix1 + 1.0, 0.0) * np.maximum(iy2 - iy1 + 1.0, 0.0)
            area_b = (b[2] - b[0] + 1.0) * (b[3] - b[1] + 1.0)
            area_g = (g[:, 2] - g[:, 0] + 1.0) * (g[:, 3] - g[:, 1] + 1.0)
            iou = inter / (area_b + area_g - inter)
            best_j = int(np.argmax(iou))
            best_iou = float(iou[best_j])
        if best_iou >= iou_thresh:
            if rec["difficult"][best_j]:
                continue
            if not matched[det["image_id"]][best_j]:
                matched[det["image_id"]][best_j] = True
                tp[i] = 1
            else:
                fp[i] = 1
        else:
            fp[i] = 1
    tp_c = np.cumsum(tp)
    fp_c = np.cumsum(fp)
    recall = tp_c / max(npos, 1)
    precision = tp_c / np.maximum(tp_c + fp_c, np.finfo(np.float64).eps)
    return {"ap": voc_ap(recall, precision, use_07_metric), "rec": float(recall[-1]) if len(recall) else 0.0}


class PascalVOCDetectionEvaluator(DatasetEvaluator):
    """AP50 of each class with ground truth and their mean, in percent:
    ``{"bbox": {"AP50-<class>", ..., "AP50"}}``. ``process`` reads the
    records' XYXY annotation boxes and the runner's boxes, scores, classes
    and valid slots."""

    def __init__(self, class_names: List[str], use_07_metric: bool = True):
        self._class_names = class_names
        self._use_07 = use_07_metric
        self.reset()

    def reset(self):
        self._dets: Dict[int, List[dict]] = defaultdict(list)
        self._gt: Dict[int, Dict] = defaultdict(dict)

    def process(self, inputs: List[dict], outputs: List[dict]):
        for record, output in zip(inputs, outputs):
            img_id = record["image_id"]
            by_cls: Dict[int, Dict[str, list]] = defaultdict(lambda: {"boxes": [], "difficult": []})
            for a in record.get("annotations", []):
                by_cls[a["category_id"]]["boxes"].append(a["bbox"])
                by_cls[a["category_id"]]["difficult"].append(bool(a.get("difficult", False)))
            for c, v in by_cls.items():
                self._gt[c][img_id] = v
            boxes = np.asarray(output["boxes"])
            scores = np.asarray(output["scores"])
            classes = np.asarray(output["classes"])
            valid = np.asarray(output.get("valid", scores > 0))
            for i in np.flatnonzero(valid):
                self._dets[int(classes[i])].append({"image_id": img_id, "score": float(scores[i]),
                                                    "box": boxes[i].tolist()})

    def evaluate(self) -> Optional[Dict[str, Dict[str, float]]]:
        """{"bbox": AP50 and AP50 by class} on the main process, None on the others."""
        gathered = process_allgather((dict(self._dets), dict(self._gt)))
        if not is_main_process():
            return None
        dets: Dict[int, List[dict]] = defaultdict(list)
        gt: Dict[int, Dict] = defaultdict(dict)
        for d, g in gathered:
            for c, lst in d.items():
                dets[c].extend(lst)
            for c, per_img in g.items():
                gt[c].update(per_img)
        aps = []
        res = {}
        for c, name in enumerate(self._class_names):
            if c not in gt:
                continue
            r = voc_eval_class(gt[c], dets.get(c, []), use_07_metric=self._use_07)
            aps.append(r["ap"])
            res[f"AP50-{name}"] = 100 * r["ap"]
        res["AP50"] = 100 * float(np.mean(aps)) if aps else 0.0
        return {"bbox": res}
