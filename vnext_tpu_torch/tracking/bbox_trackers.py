"""Frame-to-frame box trackers on the host.

Counterpart of ``vnext_tpu.tracking.bbox_trackers`` (reference surface:
detectron2/tracking/: BaseTracker base_tracker.py:15, BBoxIOUTracker
bbox_iou_tracker.py:17, vanilla_hungarian_bbox_iou_tracker.py:17,
iou_weighted_hungarian_bbox_iou_tracker.py:14). Each takes one frame's
detections as a dict of host arrays ({"boxes" [N, 4] xyxy, "classes" [N],
"scores" [N] for the IoU-weighted one}) and returns it with "ids" [N]: a
detection takes the id of the previous frame's box of its class that it
overlaps at ``track_iou_threshold`` or more (greedily by IoU, or by
``scipy``'s optimal assignment), else a new id. numpy in f64, as the JAX
package's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.optimize import linear_sum_assignment


def _pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None] - inter
    return inter / np.maximum(union, 1e-12)


def _host(x) -> np.ndarray:
    """A host array of a numpy array, a list or a tensor (on any device)."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


class BaseTracker:
    """Protocol: update({"boxes": [N, 4] xyxy, "classes": [N]}) -> the same with "ids" [N]."""

    def __init__(self, track_iou_threshold: float = 0.5, max_lost_frames: int = 30):
        self._iou_thr = track_iou_threshold
        self._max_lost = max_lost_frames
        self._next_id = 0
        self._prev: Optional[Dict] = None
        self._lost: Dict[int, int] = {}

    def reset(self):
        self._next_id = 0
        self._prev = None
        self._lost = {}

    def update(self, instances: Dict) -> Dict:
        raise NotImplementedError

    def _new_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    def _frame(self, instances: Dict):
        """(boxes [N, 4] f64, classes [N] int64, ids [N] all -1, and the IoU
        [N, M] with the previous frame's boxes, zero across classes; None when
        either frame is empty)."""
        boxes = _host(instances["boxes"]).astype(np.float64).reshape(-1, 4)
        classes = _host(instances.get("classes", np.zeros(len(boxes)))).astype(np.int64)
        ids = np.full(len(boxes), -1, np.int64)
        iou = None
        if self._prev is not None and len(self._prev["boxes"]) and len(boxes):
            same_cls = classes[:, None] == self._prev["classes"][None]
            iou = np.where(same_cls, _pairwise_iou(boxes, self._prev["boxes"]), 0.0)
        return boxes, classes, ids, iou

    def _finish(self, instances: Dict, boxes, classes, ids) -> Dict:
        for i in range(len(boxes)):
            if ids[i] == -1:
                ids[i] = self._new_id()
        self._prev = {"boxes": boxes, "classes": classes, "ids": ids}
        out = dict(instances)
        out["ids"] = ids
        return out


class BBoxIOUTracker(BaseTracker):
    """Greedy highest-IoU association (reference bbox_iou_tracker.py:17)."""

    def update(self, instances: Dict) -> Dict:
        boxes, classes, ids, iou = self._frame(instances)
        if iou is not None:
            order = np.dstack(np.unravel_index(np.argsort(-iou, axis=None), iou.shape))[0]
            used_prev = set()
            for di, pi in order:
                if iou[di, pi] < self._iou_thr:
                    break
                if ids[di] != -1 or pi in used_prev:
                    continue
                ids[di] = self._prev["ids"][pi]
                used_prev.add(pi)
        return self._finish(instances, boxes, classes, ids)


class VanillaHungarianBBoxIOUTracker(BaseTracker):
    """Optimal one-to-one association of cost 1 - IoU (reference
    vanilla_hungarian_bbox_iou_tracker.py:17)."""

    def _cost(self, iou: np.ndarray) -> np.ndarray:
        return 1.0 - iou

    def update(self, instances: Dict) -> Dict:
        boxes, classes, ids, iou = self._frame(instances)
        if iou is not None:
            rows, cols = linear_sum_assignment(self._cost(iou))
            for r, c in zip(rows, cols):
                if iou[r, c] >= self._iou_thr:
                    ids[r] = self._prev["ids"][c]
        return self._finish(instances, boxes, classes, ids)


class IOUWeightedHungarianBBoxIOUTracker(VanillaHungarianBBoxIOUTracker):
    """The Hungarian association of cost 1 - IoU x the detection's score
    (reference iou_weighted_hungarian_bbox_iou_tracker.py:14)."""

    def update(self, instances: Dict) -> Dict:
        self._scores = _host(instances.get("scores", [])).astype(np.float64)
        return super().update(instances)

    def _cost(self, iou: np.ndarray) -> np.ndarray:
        if self._scores is not None and len(self._scores) == iou.shape[0]:
            return 1.0 - iou * self._scores[:, None]
        return 1.0 - iou
