"""LVIS instance evaluation: COCO-style AP with the frequency bands' APr,
APc and APf.

Counterpart of ``vnext_tpu.evaluation.lvis_eval`` (reference surface:
detectron2/evaluation/lvis_evaluation.py LVISEvaluator): the predictions are
scored by ``COCOEvaluator._evaluate_predictions`` over all categories, then
once more over the categories of each frequency band (rare, common,
frequent, from the ground-truth json's ``frequency``), whose AP is added to
each task's dict as ``APr`` / ``APc`` / ``APf`` where the band has
categories. This is plain COCO AP, not LVIS's federated protocol (the
``neg_category_ids`` / ``not_exhaustive_category_ids`` are not read), as in
the JAX package (ROADMAP Queue 3, item 5). Predictions are not thresholded:
the configs keep up to 300 an image.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional

from ..parallel.mesh import is_main_process, process_allgather
from .coco_eval import COCOEvaluator

logger = logging.getLogger("vnext_tpu_torch")


class LVISEvaluator(COCOEvaluator):
    def evaluate(self) -> Optional[Dict[str, Dict[str, float]]]:
        """Gathers every process's predictions; on the main process writes
        ``lvis_instances_results.json`` under the output directory and returns
        {task: stats}, or {} where the dataset has no ground-truth json; None
        on the others."""
        chunks = process_allgather(self._predictions)
        if not is_main_process():
            return None
        predictions = [p for c in chunks for p in c]
        if self._output_dir:
            os.makedirs(self._output_dir, exist_ok=True)
            with open(os.path.join(self._output_dir, "lvis_instances_results.json"), "w") as f:
                json.dump(predictions, f)
        json_file = self._metadata.get("json_file")
        if not json_file or not os.path.exists(json_file):
            logger.info("No GT json for %s; results written only", self._dataset_name)
            return {}
        with open(json_file) as f:
            gt = json.load(f)
        # LVIS categories carry synonyms; give each a COCO name
        for c in gt.get("categories", []):
            c.setdefault("name", (c.get("synonyms") or ["?"])[0])

        results = self._evaluate_predictions(gt, predictions)
        groups = {"r": set(), "c": set(), "f": set()}
        for c in gt.get("categories", []):
            if c.get("frequency") in groups:
                groups[c["frequency"]].add(c["id"])
        for tag, cat_ids in groups.items():
            if not cat_ids:
                continue
            sub_gt = dict(gt, annotations=[a for a in gt.get("annotations", []) if a["category_id"] in cat_ids],
                          categories=[c for c in gt.get("categories", []) if c["id"] in cat_ids])
            sub = self._evaluate_predictions(sub_gt, [p for p in predictions if p["category_id"] in cat_ids])
            for task, stats in sub.items():
                if "AP" in stats:
                    results[task][f"AP{tag}"] = stats["AP"]
        return results
