"""Rotated-box detection evaluation: COCO-style AP with the exact rotated IoU.

Counterpart of ``vnext_tpu.evaluation.rotated_coco_eval`` (reference surface:
detectron2/evaluation/rotated_coco_evaluation.py RotatedCOCOEvaluator). Per
class, the detections by score are matched greedily to the images' ground
truth at each IoU threshold .50:.05:.95, the IoU being
``ops/rotated_boxes.pairwise_iou_rotated`` (on the host, in f32); each
threshold's AP is the area under the precision envelope (``voc_ap``), and
AP / AP50 / AP75 average over the classes with ground truth. Every process's part is gathered to the main process, which alone scores
it (``parallel.process_allgather``); the others' ``evaluate`` returns None.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.rotated_boxes import pairwise_iou_rotated
from ..parallel.mesh import is_main_process, process_allgather
from .pascal_voc_eval import voc_ap
from .ytvis_eval import DatasetEvaluator

_IOU_THRESHS = np.arange(0.5, 1.0, 0.05)


def _rotated_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return pairwise_iou_rotated(torch.from_numpy(a), torch.from_numpy(b)).numpy()


class RotatedCOCOEvaluator(DatasetEvaluator):
    """AP / AP50 / AP75 (and AP by class with ``class_names``) of (cx, cy, w,
    h, angle) detections. ``process`` takes outputs {boxes [N, 5], scores,
    classes, valid} and inputs carrying "image_id" and "annotations"
    [{category_id, bbox (5,)}]."""

    def __init__(self, class_names: Optional[List[str]] = None):
        self._class_names = class_names
        self.reset()

    def reset(self):
        self._dets: Dict[int, List[dict]] = defaultdict(list)
        self._gt: Dict[int, Dict] = defaultdict(dict)

    def process(self, inputs: List[dict], outputs: List[dict]):
        for record, output in zip(inputs, outputs):
            img_id = record["image_id"]
            by_cls = defaultdict(list)
            for a in record.get("annotations", []):
                by_cls[a["category_id"]].append(a["bbox"])
            for c, boxes in by_cls.items():
                self._gt[c][img_id] = np.asarray(boxes, np.float32)
            host = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                    for k, v in output.items()}
            boxes, scores, classes = host["boxes"].astype(np.float32), host["scores"], host["classes"]
            valid = host.get("valid", scores > 0)
            for i in np.flatnonzero(valid):
                self._dets[int(classes[i])].append({"image_id": img_id, "score": float(scores[i]), "box": boxes[i]})

    def _eval_class(self, gt_by_image: Dict, dets: List[dict]) -> np.ndarray:
        """AP at each IoU threshold for one class."""
        npos = sum(len(v) for v in gt_by_image.values())
        dets = sorted(dets, key=lambda d: -d["score"])
        aps = np.zeros(len(_IOU_THRESHS))
        if not dets or npos == 0:
            return aps
        det_iou = []
        for d in dets:
            g = gt_by_image.get(d["image_id"])
            det_iou.append(np.zeros(0) if g is None or not len(g) else _rotated_iou_matrix(d["box"][None], g)[0])
        for t_i, thr in enumerate(_IOU_THRESHS):
            matched = {k: np.zeros(len(v), bool) for k, v in gt_by_image.items()}
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for i, d in enumerate(dets):
                iou = det_iou[i].copy()
                if len(iou):
                    iou[matched[d["image_id"]]] = -1.0       # ground truth already claimed
                    j = int(np.argmax(iou))
                    if iou[j] >= thr:
                        matched[d["image_id"]][j] = True
                        tp[i] = 1
                        continue
                fp[i] = 1
            tp_c, fp_c = np.cumsum(tp), np.cumsum(fp)
            aps[t_i] = voc_ap(tp_c / npos, tp_c / np.maximum(tp_c + fp_c, 1e-9))
        return aps

    def evaluate(self) -> Optional[Dict[str, Dict[str, float]]]:
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
        per_class = {c: self._eval_class(gt[c], dets.get(c, [])) for c in gt}
        if not per_class:
            return {"bbox": {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}}
        all_aps = np.stack(list(per_class.values()))       # [C, T]
        res = {"AP": 100 * float(all_aps.mean()), "AP50": 100 * float(all_aps[:, 0].mean()),
               "AP75": 100 * float(all_aps[:, 5].mean())}
        if self._class_names:
            for c, aps in per_class.items():
                res[f"AP-{self._class_names[c]}"] = 100 * float(aps.mean())
        return {"bbox": res}
