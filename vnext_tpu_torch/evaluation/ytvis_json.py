"""YouTube-VIS ``results.json`` entries: the per-video writer.

Counterpart of ``vnext_tpu.evaluation.ytvis_eval.video_output_to_json``: one
entry per (instance, class) of a video's predictions, every frame's mask as a
compressed COCO RLE (``evaluation/rle.py``), the category remapped from the
contiguous id to the dataset's (by default 0-based to 1-based).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .rle import rle_encode

__all__ = ["rle_encode", "video_output_to_json"]


def video_output_to_json(
    output: dict,
    video_id: int,
    height: Optional[int] = None,
    width: Optional[int] = None,
    reverse_id_map: Optional[dict] = None,
) -> List[dict]:
    """One video's predictions (a runner's output) -> results.json entries. A
    frame where the instance is absent gets an all-zero mask of the video's
    size (``height`` x ``width``, by default the output's ``image_size``)."""
    if height is None or width is None:
        height, width = output["image_size"]
    results = []
    for score, label, inst_masks in zip(
        output["pred_scores"], output["pred_labels"], output["pred_masks"]
    ):
        segms = [
            rle_encode(np.zeros((height, width), bool) if m is None else np.asarray(m, bool))
            for m in inst_masks
        ]
        category_id = reverse_id_map[int(label)] if reverse_id_map else int(label) + 1
        results.append({
            "video_id": int(video_id),
            "score": float(score),
            "category_id": int(category_id),
            "segmentations": segms,
        })
    return results
