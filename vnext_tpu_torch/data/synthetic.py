"""Synthetic YTVIS-style videos held in memory, for tests and benchmarks.

Counterpart of ``vnext_tpu.data.synthetic``: videos of moving coloured
rectangles with exact boxes and polygon masks, in the record format of
``datasets/ytvis.py``, their frames in a dict keyed by ``synthetic://`` file
names, and an image loader that reads that dict in place of the disk. The same
seed gives the JAX package's records and pixels.
"""

from __future__ import annotations

import random
from typing import Dict, List, Tuple

import numpy as np


def make_synthetic_videos(
    num_videos: int = 4,
    length: int = 8,
    height: int = 360,
    width: int = 640,
    max_objects: int = 4,
    num_classes: int = 40,
    seed: int = 0,
) -> Tuple[List[dict], Dict[str, np.ndarray]]:
    """Returns (dataset_dicts, image_store). file_names are keys into image_store."""
    rng = np.random.RandomState(seed)
    records = []
    store: Dict[str, np.ndarray] = {}
    ann_id = 1
    for vid in range(num_videos):
        n_obj = int(rng.randint(1, max_objects + 1))
        # object state: position, velocity, size, class
        pos = rng.rand(n_obj, 2) * [width * 0.6, height * 0.6] + [width * 0.1, height * 0.1]
        vel = (rng.rand(n_obj, 2) - 0.5) * 20
        size = rng.rand(n_obj, 2) * [width * 0.2, height * 0.2] + [30, 30]
        cls = rng.randint(0, num_classes, n_obj)
        colors = rng.randint(50, 255, (n_obj, 3))

        file_names = []
        bboxes = [[] for _ in range(n_obj)]
        segms = [[] for _ in range(n_obj)]
        for t in range(length):
            img = np.full((height, width, 3), 30, np.uint8)
            for i in range(n_obj):
                x0 = pos[i, 0] + vel[i, 0] * t
                y0 = pos[i, 1] + vel[i, 1] * t
                x1 = min(x0 + size[i, 0], width - 1)
                y1 = min(y0 + size[i, 1], height - 1)
                x0 = max(x0, 0)
                y0 = max(y0, 0)
                if x1 - x0 < 4 or y1 - y0 < 4:
                    bboxes[i].append(None)
                    segms[i].append(None)
                    continue
                xi0, yi0, xi1, yi1 = int(x0), int(y0), int(x1), int(y1)
                img[yi0:yi1, xi0:xi1] = colors[i]
                bboxes[i].append([float(xi0), float(yi0), float(xi1 - xi0), float(yi1 - yi0)])
                segms[i].append(
                    [[float(xi0), float(yi0), float(xi1), float(yi0),
                      float(xi1), float(yi1), float(xi0), float(yi1)]]
                )
            fname = f"synthetic://{vid}/{t}"
            store[fname] = img
            file_names.append(fname)

        record = {
            "file_names": file_names,
            "height": height,
            "width": width,
            "length": length,
            "video_id": vid + 1,
            "annotations": [],
        }
        for t in range(length):
            frame_objs = []
            for i in range(n_obj):
                if bboxes[i][t] is None:
                    continue
                frame_objs.append(
                    {
                        "iscrowd": 0,
                        "id": ann_id + i,
                        "category_id": int(cls[i]),
                        "bbox": bboxes[i][t],
                        "segmentation": segms[i][t],
                    }
                )
            record["annotations"].append(frame_objs)
        ann_id += n_obj
        records.append(record)
    return records, store


def make_image_loader(store: Dict[str, np.ndarray]):
    """A mapper's ``image_loader`` that reads ``store`` (no file is opened)."""

    def load(path: str) -> np.ndarray:
        return store[path]

    return load
