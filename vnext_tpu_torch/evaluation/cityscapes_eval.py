"""Cityscapes evaluation: instance mask AP and semantic mIoU.

Counterpart of ``vnext_tpu.evaluation.cityscapes_eval`` (reference surface:
detectron2/evaluation/cityscapes_evaluation.py). The reference runs
cityscapesscripts over files it writes; here, as in the JAX package, the
instance AP is the video evaluator's accumulation (``YTVOSeval``) with every
image a one-frame video keyed by its string id and the ground truth taken
from the records' RLE masks (ROADMAP Queue 3, item 5), and the semantic
mIoU is ``SemSegEvaluator``'s over the 19 train ids with the ground truth
read from each record's labelTrainIds PNG. Every process's part is gathered to the main process, which alone scores
it (``parallel.process_allgather``); the others' ``evaluate`` returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..parallel.mesh import is_main_process, process_allgather
from .rle import rle_encode
from .sem_seg_eval import SemSegEvaluator
from .ytvis_eval import DatasetEvaluator
from .ytvos_eval import YTVOSeval


class CityscapesInstanceEvaluator(DatasetEvaluator):
    """Mask AP over the thing classes (``{"segm": stats}``, fractions).
    ``process`` reads the records of ``data/datasets/cityscapes.py`` (RLE
    ground truth inline) and the runner's scores, classes, valid slots and
    masks [N, H, W]."""

    def __init__(self, class_names: Optional[List[str]] = None):
        self._class_names = class_names
        self.reset()

    def reset(self):
        self._gt_annos: List[dict] = []
        self._videos: List[dict] = []
        self._preds: List[dict] = []

    def process(self, inputs: List[dict], outputs: List[dict]):
        for record, output in zip(inputs, outputs):
            img_id = record["image_id"]
            self._videos.append({"id": img_id, "height": record["height"], "width": record["width"], "length": 1,
                                 "file_names": [record.get("file_name", "")]})
            for a in record.get("annotations", []):
                self._gt_annos.append({"id": len(self._gt_annos) + 1, "video_id": img_id,
                                       "category_id": a["category_id"] + 1, "segmentations": [a["segmentation"]],
                                       "iscrowd": 0})
            scores = np.asarray(output["scores"])
            classes = np.asarray(output["classes"])
            valid = np.asarray(output.get("valid", scores > 0))
            masks = output["masks"]
            for i in np.flatnonzero(valid):
                self._preds.append({"video_id": img_id, "category_id": int(classes[i]) + 1,
                                    "score": float(scores[i]),
                                    "segmentations": [rle_encode(np.asarray(masks[i], bool))]})

    def evaluate(self) -> Optional[Dict[str, Dict[str, float]]]:
        chunks = process_allgather((self._videos, self._gt_annos, self._preds))
        if not is_main_process():
            return None
        videos = [v for c in chunks for v in c[0]]
        gt_annos = [a for c in chunks for a in c[1]]
        preds = [p for c in chunks for p in c[2]]
        names = self._class_names
        n_cls = len(names) if names else max([g["category_id"] for g in gt_annos], default=0)
        gt = {"videos": videos,
              "categories": [{"id": i + 1, "name": names[i] if names else str(i)} for i in range(n_cls)],
              "annotations": gt_annos}
        return {"segm": YTVOSeval(gt, preds).evaluate()}


class CityscapesSemSegEvaluator(SemSegEvaluator):
    """mIoU over the 19 train classes (255 ignored); the ground truth is each
    record's ``sem_seg_gt`` array where it has one, else its
    ``sem_seg_file_name`` PNG."""

    def __init__(self, class_names: Optional[List[str]] = None):
        from ..data.datasets.cityscapes import CITYSCAPES_SEM_SEG_CLASSES

        names = list(class_names or CITYSCAPES_SEM_SEG_CLASSES)
        super().__init__(num_classes=len(names), ignore_label=255, class_names=names)
