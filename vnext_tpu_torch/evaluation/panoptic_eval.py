"""Panoptic quality: PQ = SQ x RQ over segments matched at IoU > 0.5, with
the thing and stuff splits.

Counterpart of ``vnext_tpu.evaluation.panoptic_eval`` (reference surface:
detectron2/evaluation/panoptic_evaluation.py COCOPanopticEvaluator, whose
math is panopticapi's), on (id map, segments' info) pairs with one
intersection histogram per image. Every process's per-category sums are
added on the main process, which alone scores them
(``parallel.process_allgather``); the others' ``evaluate`` returns None. The
ground truth is the record's ``pan_seg`` id map where
it has one, else ``rgb2id`` of its ``pan_seg_file_name`` PNG (the JAX package
reads the array only, which its loader does not give: ROADMAP Queue 3,
item 6).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from ..data.datasets.coco_panoptic import rgb2id
from ..parallel.mesh import is_main_process, process_allgather
from .ytvis_eval import DatasetEvaluator

VOID = 0


def pq_single_image(pan_gt: np.ndarray, segments_gt: List[dict], pan_pred: np.ndarray, segments_pred: List[dict],
                    stats: Dict[int, np.ndarray]) -> None:
    """Accumulate each category's [iou_sum, tp, fp, fn] into ``stats``.

    pan_*: [H, W] segment-id maps (0 = void); segments_*: [{"id",
    "category_id", optional "iscrowd"}]. A match is a ground-truth and a
    predicted segment of one category at IoU > 0.5, where the union leaves
    out the prediction's void pixels; a crowd segment is never matched nor
    missed, and an unmatched prediction lying more than half on void or on
    its category's crowd is no false positive (panopticapi's rules).
    """
    gt_info = {s["id"]: s for s in segments_gt}
    pred_info = {s["id"]: s for s in segments_pred}
    gt_area = {i: int(a) for i, a in zip(*np.unique(pan_gt, return_counts=True))}
    pred_area = {i: int(a) for i, a in zip(*np.unique(pan_pred, return_counts=True))}

    combo = pan_gt.astype(np.int64) * (2 ** 32) + pan_pred.astype(np.int64)
    ids, counts = np.unique(combo, return_counts=True)
    inter = {(int(i // 2 ** 32), int(i % 2 ** 32)): int(c) for i, c in zip(ids, counts)}

    matched_gt, matched_pred = set(), set()
    for (gid, pid), c in inter.items():
        if gid not in gt_info or pid not in pred_info:
            continue
        g, p = gt_info[gid], pred_info[pid]
        if g.get("iscrowd", 0) or g["category_id"] != p["category_id"]:
            continue
        union = gt_area[gid] + pred_area[pid] - c - inter.get((VOID, pid), 0)
        iou = c / max(union, 1)
        if iou > 0.5:
            cat = g["category_id"]
            stats.setdefault(cat, np.zeros(4))
            stats[cat] += [iou, 1, 0, 0]
            matched_gt.add(gid)
            matched_pred.add(pid)
    crowd_by_cat = {g["category_id"]: gid for gid, g in gt_info.items() if g.get("iscrowd", 0)}
    for gid, g in gt_info.items():
        if gid in matched_gt or g.get("iscrowd", 0):
            continue
        stats.setdefault(g["category_id"], np.zeros(4))
        stats[g["category_id"]] += [0, 0, 0, 1]
    for pid, p in pred_info.items():
        if pid in matched_pred:
            continue
        ignored = inter.get((VOID, pid), 0)
        crowd_gid = crowd_by_cat.get(p["category_id"])
        if crowd_gid is not None:
            ignored += inter.get((crowd_gid, pid), 0)
        if ignored / max(pred_area.get(pid, 1), 1) > 0.5:
            continue
        stats.setdefault(p["category_id"], np.zeros(4))
        stats[p["category_id"]] += [0, 0, 1, 0]


def panoptic_ground_truth(record: dict) -> np.ndarray:
    """[H, W] segment ids: the record's ``pan_seg``, else ``rgb2id`` of its PNG."""
    if "pan_seg" in record:
        return np.asarray(record["pan_seg"])
    with Image.open(record["pan_seg_file_name"]) as im:
        return rgb2id(np.asarray(im.convert("RGB")))


class COCOPanopticEvaluator(DatasetEvaluator):
    """PQ / SQ / RQ of outputs {"panoptic_seg": ([H, W] id map, segments' info)}
    against the records' ground truth and ``segments_info``; with
    ``thing_ids``, also over the thing categories (``_th``) and the others
    (``_st``)."""

    def __init__(self, thing_ids: Optional[set] = None):
        self._thing_ids = thing_ids
        self._stats: Dict[int, np.ndarray] = {}

    def reset(self):
        self._stats = {}

    def process(self, inputs: List[dict], outputs: List[dict]):
        for record, output in zip(inputs, outputs):
            pan_pred, segments_pred = output["panoptic_seg"]
            pq_single_image(panoptic_ground_truth(record), record["segments_info"], np.asarray(pan_pred),
                            segments_pred, self._stats)

    def evaluate(self) -> Optional[Dict[str, Dict[str, float]]]:
        """{"panoptic_seg": {"PQ", "SQ", "RQ" (and their _th / _st)}}, in
        percent, each the mean over the categories seen."""
        chunks = process_allgather(dict(self._stats))
        if not is_main_process():
            return None
        stats: Dict[int, np.ndarray] = defaultdict(lambda: np.zeros(4))
        for chunk in chunks:
            for cat, v in chunk.items():
                stats[cat] += v

        def agg(cats):
            pqs, sqs, rqs, n = [], [], [], 0
            for cat in cats:
                iou_sum, tp, fp, fn = stats[cat]
                if tp + fp + fn == 0:
                    continue
                n += 1
                sq = iou_sum / tp if tp else 0.0
                rq = tp / (tp + 0.5 * fp + 0.5 * fn)
                pqs.append(sq * rq)
                sqs.append(sq)
                rqs.append(rq)
            if not n:
                return 0.0, 0.0, 0.0
            return 100 * float(np.mean(pqs)), 100 * float(np.mean(sqs)), 100 * float(np.mean(rqs))

        pq, sq, rq = agg(stats.keys())
        res = {"PQ": pq, "SQ": sq, "RQ": rq}
        if self._thing_ids is not None:
            th = [c for c in stats if c in self._thing_ids]
            st = [c for c in stats if c not in self._thing_ids]
            res["PQ_th"], res["SQ_th"], res["RQ_th"] = agg(th)
            res["PQ_st"], res["SQ_st"], res["RQ_st"] = agg(st)
        return {"panoptic_seg": res}
