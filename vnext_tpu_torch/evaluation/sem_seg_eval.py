"""Semantic segmentation evaluator: a confusion matrix, then mIoU, fwIoU,
pACC, mACC and each present class's IoU.

Counterpart of ``vnext_tpu.evaluation.sem_seg_eval`` (reference surface:
detectron2/evaluation/sem_seg_evaluation.py SemSegEvaluator). Every
process's confusion matrix is summed on the main process, which alone scores
it (``parallel.process_allgather``); the others' ``evaluate`` returns None.
The ground truth is the record's
``sem_seg_gt`` array where it has one, else its ``sem_seg_file_name`` PNG (the
JAX package reads the array only, which no loader gives: ROADMAP Queue 3,
item 6).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from ..parallel.mesh import is_main_process, process_allgather
from .ytvis_eval import DatasetEvaluator


def sem_seg_ground_truth(record: dict) -> np.ndarray:
    """[H, W] labels: the record's ``sem_seg_gt``, else its ``sem_seg_file_name`` PNG."""
    if "sem_seg_gt" in record:
        return np.asarray(record["sem_seg_gt"])
    with Image.open(record["sem_seg_file_name"]) as im:
        return np.asarray(im)


class SemSegEvaluator(DatasetEvaluator):
    """Accumulates a C x C confusion matrix (ground truth by prediction) of
    outputs {"sem_seg": [H, W] predicted classes}, leaving out the pixels
    labelled ``ignore_label``; predictions are clipped to [0, C)."""

    def __init__(self, num_classes: int, ignore_label: int = 255, class_names: Optional[List[str]] = None):
        self._num_classes = num_classes
        self._ignore_label = ignore_label
        self._class_names = class_names or [str(i) for i in range(num_classes)]
        self._conf = np.zeros((num_classes, num_classes), np.int64)

    def reset(self):
        self._conf = np.zeros((self._num_classes, self._num_classes), np.int64)

    def process(self, inputs: List[dict], outputs: List[dict]):
        n = self._num_classes
        for record, output in zip(inputs, outputs):
            pred = np.asarray(output["sem_seg"], np.int64).reshape(-1)
            gt = sem_seg_ground_truth(record).astype(np.int64).reshape(-1)
            valid = gt != self._ignore_label
            pred = np.clip(pred[valid], 0, n - 1)
            self._conf += np.bincount(gt[valid] * n + pred, minlength=n ** 2).reshape(n, n)

    def evaluate(self) -> Optional[Dict[str, Dict[str, float]]]:
        """{"sem_seg": {"mIoU", "fwIoU", "pACC", "mACC", "IoU-<class>" of each
        class present in the ground truth}}, in percent."""
        chunks = process_allgather(self._conf)
        if not is_main_process():
            return None
        conf = np.sum(np.stack(chunks), axis=0)
        tp = np.diag(conf).astype(np.float64)
        pos_gt = conf.sum(1).astype(np.float64)
        pos_pred = conf.sum(0).astype(np.float64)
        union = pos_gt + pos_pred - tp
        class_present = pos_gt > 0
        iou = np.full(self._num_classes, np.nan)
        iou[union > 0] = tp[union > 0] / union[union > 0]
        acc = np.full(self._num_classes, np.nan)
        acc[pos_gt > 0] = tp[pos_gt > 0] / pos_gt[pos_gt > 0]
        miou = float(np.nanmean(iou[class_present])) if class_present.any() else 0.0
        freq = pos_gt / max(pos_gt.sum(), 1.0)
        fwiou = float(np.nansum(np.where(np.isnan(iou), 0.0, iou) * freq))
        pacc = float(tp.sum() / max(pos_gt.sum(), 1.0))
        macc = float(np.nanmean(acc[class_present])) if class_present.any() else 0.0
        res = {"mIoU": 100 * miou, "fwIoU": 100 * fwiou, "pACC": 100 * pacc, "mACC": 100 * macc}
        for i, name in enumerate(self._class_names):
            if class_present[i]:
                res[f"IoU-{name}"] = 100 * float(iou[i]) if not np.isnan(iou[i]) else 0.0
        return {"sem_seg": res}
