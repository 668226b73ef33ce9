"""Video-instance-segmentation mAP over tube IoU (YTVOS-style).

Counterpart of ``vnext_tpu.evaluation.ytvos_eval``: COCO-style AP / AR where
the unit is a video tube. The IoU of a predicted and a ground-truth masklet is
the sum over frames of the intersections over the sum of the unions, a frame
where either mask is absent counting as empty; matching is greedy per category
at 10 IoU thresholds, precision is interpolated at 101 recall points, and
tubes are binned by their mean per-frame area over the frames where they are
present.

Inputs are YTVIS-format dicts:
    gt:      {"videos": [...], "annotations": [{video_id, category_id,
              segmentations: [rle | None per frame], iscrowd, id}], "categories": [...]}
    results: [{video_id, category_id, score, segmentations: [rle | None]}]

The tube IoUs and the matching run in C (``native.py``) where a compiler is
present, else in Python; both give the same stats.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import native
from .rle import rle_counts

logger = logging.getLogger("vnext_tpu_torch")


def _avg_area(segms: Sequence[Optional[dict]]) -> float:
    """Mean per-frame mask area over the frames where the mask is present and
    not empty; 0 for a tube empty everywhere."""
    areas = [a for a in (float(sum(rle_counts(s)[1::2])) for s in segms if s is not None) if a]
    return float(np.mean(areas)) if areas else 0.0


def _rle_intersection_union(a: Optional[dict], b: Optional[dict]) -> Tuple[float, float]:
    """(intersection, union) pixel counts of two RLE masks (either may be None)."""
    if a is None and b is None:
        return 0.0, 0.0
    if a is None or b is None:
        return 0.0, float(sum(rle_counts(a if a is not None else b)[1::2]))
    ca, cb = rle_counts(a), rle_counts(b)
    # run-length merge: walk both RLEs at once
    inter = 0.0
    union = 0.0
    ia = ib = 0
    va = vb = 0
    rem_a = float(ca[0]) if ca else 0.0
    rem_b = float(cb[0]) if cb else 0.0
    total = sum(ca)
    pos = 0.0
    while pos < total and ia < len(ca) and ib < len(cb):
        step = min(rem_a, rem_b)
        if va and vb:
            inter += step
        if va or vb:
            union += step
        rem_a -= step
        rem_b -= step
        pos += step
        if rem_a == 0:
            ia += 1
            va ^= 1
            rem_a = float(ca[ia]) if ia < len(ca) else float("inf")
        if rem_b == 0:
            ib += 1
            vb ^= 1
            rem_b = float(cb[ib]) if ib < len(cb) else float("inf")
    return inter, union


def tube_iou(
    det_segms: Sequence[Optional[dict]],
    gt_segms: Sequence[Optional[dict]],
    iscrowd: bool = False,
) -> float:
    inter = 0.0
    union = 0.0
    det_area = 0.0
    for d, g in zip(det_segms, gt_segms):
        i, u = _rle_intersection_union(d, g)
        inter += i
        union += u
        if d is not None:
            det_area += float(sum(rle_counts(d)[1::2]))
    if iscrowd:
        # crowd ground truth: IoU against the detection's area only (COCO convention)
        return inter / det_area if det_area > 0 else 0.0
    return inter / union if union > 0 else 0.0


def _tube_iou_matrix(dt_anns, gt_anns) -> np.ndarray:
    """[D, G] tube IoUs, in C where the native library is there."""
    if gt_anns and dt_anns and native.available():
        return native.tube_iou_matrix_native(
            [d["segmentations"] for d in dt_anns],
            [g["segmentations"] for g in gt_anns],
            [bool(g.get("iscrowd", 0)) for g in gt_anns],
        )
    iou = np.zeros((len(dt_anns), len(gt_anns)))
    for di, d in enumerate(dt_anns):
        for gi, g in enumerate(gt_anns):
            iou[di, gi] = tube_iou(
                d["segmentations"], g["segmentations"], iscrowd=bool(g.get("iscrowd", 0))
            )
    return iou


def _match_greedy(
    iou: np.ndarray,
    gt_ignore: np.ndarray,
    thrs: np.ndarray,
    iscrowd: Optional[np.ndarray] = None,
):
    """Greedy score-ordered matching at each threshold -> (matched, ignored)
    [T, D] bool, in C where the native library is there.

    Preconditions (pycocotools' invariants, which the caller keeps): the rows
    of ``iou`` are score-sorted, its columns ignore-last. Only crowd ground
    truths are matched twice.
    """
    d, g = iou.shape
    if iscrowd is None:
        iscrowd = np.zeros(g, bool)
    if native.available():
        return native.match_greedy_native(iou, gt_ignore, thrs, iscrowd)
    matched = np.zeros((len(thrs), d), bool)
    ignored = np.zeros((len(thrs), d), bool)
    for ti, thr in enumerate(thrs):
        gt_matched = np.zeros(g, bool)
        for di in range(d):
            best_iou = min(thr, 1 - 1e-10)
            best_gi = -1
            for gi in range(g):
                if gt_matched[gi] and not iscrowd[gi]:
                    continue
                if best_gi > -1 and not gt_ignore[best_gi] and gt_ignore[gi]:
                    break  # prefer non-ignored matches (requires the ignore-last order)
                if iou[di, gi] >= best_iou:
                    best_iou = iou[di, gi]
                    best_gi = gi
            if best_gi > -1:
                matched[ti, di] = not gt_ignore[best_gi]
                ignored[ti, di] = bool(gt_ignore[best_gi])
                gt_matched[best_gi] = True
    return matched, ignored


class YTVOSeval:
    """Greedy COCO-style evaluation over video tubes. ``iou_fn(dts, gts)`` ->
    [D, G] and ``area_fn(ann)`` replace the tube IoU and the mean mask area
    (the keypoints task: OKS and the annotation's area)."""

    def __init__(
        self,
        gt: dict,
        results: List[dict],
        iou_thrs: Optional[np.ndarray] = None,
        max_dets: Sequence[int] = (1, 10, 100),
        area_ranges: Optional[Dict[str, List[float]]] = None,
        iou_fn: Optional[Callable[[List[dict], List[dict]], np.ndarray]] = None,
        area_fn: Optional[Callable[[dict], float]] = None,
    ):
        self.gt = gt
        self.results = results
        self.iou_fn = iou_fn or _tube_iou_matrix
        self.area_fn = area_fn or (lambda ann: _avg_area(ann["segmentations"]))
        self.iou_thrs = iou_thrs if iou_thrs is not None else np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.0, 101)
        self.max_dets = list(max_dets)
        self.area_ranges = area_ranges or {
            "all": [0, 1e10],
            "small": [0, 128 ** 2],
            "medium": [128 ** 2, 256 ** 2],
            "large": [256 ** 2, 1e10],
        }
        self.cat_ids = sorted(c["id"] for c in gt.get("categories", []))
        self.video_ids = sorted(v["id"] for v in gt["videos"])
        self.stats: Dict[str, float] = {}

    def evaluate(self) -> Dict[str, float]:
        logger.info("YTVOSeval: tube IoU and matching in %s",
                    "C (native rle_ops)" if native.available() else "Python")
        gts = defaultdict(list)
        for ann in self.gt.get("annotations", []) or []:
            gts[(ann["video_id"], ann["category_id"])].append(ann)
        dts = defaultdict(list)
        for det in self.results:
            dts[(det["video_id"], det["category_id"])].append(det)

        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        n_cats = len(self.cat_ids)

        # per (cat, area, maxdet): assemble matches over all videos
        precision = -np.ones((T, R, n_cats, len(self.area_ranges), len(self.max_dets)))
        recall = -np.ones((T, n_cats, len(self.area_ranges), len(self.max_dets)))

        for ci, cat in enumerate(self.cat_ids):
            for ai, arange in enumerate(self.area_ranges.values()):
                for mi, max_det in enumerate(self.max_dets):
                    scores_all, matches_all, ignored_det_all = [], [], []
                    n_gt_total = 0
                    for vid in self.video_ids:
                        gt_anns = gts.get((vid, cat), [])
                        dt_anns = sorted(
                            dts.get((vid, cat), []), key=lambda d: -d["score"]
                        )[:max_det]
                        # mean per-frame area binning and the ignore-last ground-truth order
                        gt_ignore = np.array(
                            [
                                bool(g.get("iscrowd", 0))
                                or bool(g.get("ignore", 0))
                                or not (arange[0] <= self.area_fn(g) <= arange[1])
                                for g in gt_anns
                            ],
                            bool,
                        )
                        order = np.argsort(gt_ignore, kind="stable")
                        gt_anns = [gt_anns[i] for i in order]
                        gt_ignore = gt_ignore[order]
                        iscrowd = np.array(
                            [bool(g.get("iscrowd", 0)) for g in gt_anns], bool
                        )
                        n_gt_total += int((~gt_ignore).sum())
                        if not dt_anns:
                            continue
                        iou = self.iou_fn(dt_anns, gt_anns)
                        matched_td, ignored_td = _match_greedy(
                            iou, gt_ignore, self.iou_thrs, iscrowd
                        )
                        # unmatched detections outside the area range are ignored, not false positives
                        dt_out = np.array(
                            [
                                not (arange[0] <= self.area_fn(d) <= arange[1])
                                for d in dt_anns
                            ],
                            bool,
                        )
                        ignored_td = ignored_td | (~matched_td & dt_out[None, :])
                        for ti in range(T):
                            for di, d in enumerate(dt_anns):
                                scores_all.append((d["score"], ti))
                                matches_all.append(bool(matched_td[ti, di]))
                                ignored_det_all.append(bool(ignored_td[ti, di]))
                    if n_gt_total == 0:
                        continue
                    # precision / recall per threshold
                    for ti in range(T):
                        entries = [
                            (s, m, ig)
                            for (s, t2), m, ig in zip(scores_all, matches_all, ignored_det_all)
                            if t2 == ti
                        ]
                        entries.sort(key=lambda e: -e[0])
                        tp = np.cumsum([e[1] and not e[2] for e in entries])
                        fp = np.cumsum([(not e[1]) and (not e[2]) for e in entries])
                        if len(tp) == 0:
                            # ground truth but no detection: precision and recall are zero
                            precision[ti, :, ci, ai, mi] = 0.0
                            recall[ti, ci, ai, mi] = 0.0
                            continue
                        rc = tp / n_gt_total
                        pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
                        # make precision monotonically decreasing
                        for k in range(len(pr) - 1, 0, -1):
                            pr[k - 1] = max(pr[k - 1], pr[k])
                        inds = np.searchsorted(rc, self.rec_thrs, side="left")
                        q = np.zeros(R)
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[ti, :, ci, ai, mi] = q
                        recall[ti, ci, ai, mi] = rc[-1]

        def _summ(p_slice):
            valid = p_slice[p_slice > -1]
            return float(valid.mean()) if valid.size else float("nan")

        ai_all = list(self.area_ranges).index("all")
        mi_max = len(self.max_dets) - 1
        t50 = int(np.argmin(np.abs(self.iou_thrs - 0.5)))
        t75 = int(np.argmin(np.abs(self.iou_thrs - 0.75)))
        self.precision = precision
        self.recall = recall
        self.stats = {
            "AP": _summ(precision[:, :, :, ai_all, mi_max]),
            "AP50": _summ(precision[t50, :, :, ai_all, mi_max]),
            "AP75": _summ(precision[t75, :, :, ai_all, mi_max]),
        }
        for aname, short in (("small", "APs"), ("medium", "APm"), ("large", "APl")):
            if aname in self.area_ranges:
                self.stats[short] = _summ(
                    precision[:, :, :, list(self.area_ranges).index(aname), mi_max]
                )
        for mi, md in enumerate(self.max_dets):
            self.stats[f"AR@{md}"] = _summ(recall[:, :, ai_all, mi])
        return self.stats
