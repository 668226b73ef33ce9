"""YouTube-VIS ``results.json`` entries: COCO RLE masks and the per-video writer.

Counterpart of ``vnext_tpu.evaluation.rle.rle_encode`` and
``vnext_tpu.evaluation.ytvis_eval.video_output_to_json``: column-major run
lengths compressed with COCO's 5-bit delta scheme, byte-compatible with
pycocotools, and one entry per (instance, class) with the category remapped
from 0-based contiguous ids to 1-based.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def mask_to_counts(mask: np.ndarray) -> List[int]:
    """Binary HxW mask -> column-major run lengths, starting with a zero-run."""
    flat = np.asarray(mask, dtype=np.uint8).flatten(order="F")
    if flat.size == 0:
        return [0]
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return runs


def compress_counts(counts: List[int]) -> str:
    """COCO compression: 5-bit groups, delta-coded from counts[i-2]."""
    out = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c5 = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c5 & 0x10)) or (x == -1 and (c5 & 0x10)))
            if more:
                c5 |= 0x20
            out.append(chr(c5 + 48))
    return "".join(out)


def rle_encode(mask: np.ndarray) -> Dict:
    """HxW bool mask -> compressed COCO RLE dict."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": compress_counts(mask_to_counts(mask))}


def video_output_to_json(output: dict, video_id: int) -> List[dict]:
    """One video's predictions (``IDOLVideoInference`` output) -> results.json
    entries, categories 1-based. A frame where the instance is absent gets an
    all-zero full-size mask."""
    height, width = output["image_size"]
    results = []
    for score, label, inst_masks in zip(
        output["pred_scores"], output["pred_labels"], output["pred_masks"]
    ):
        segms = [
            rle_encode(np.zeros((height, width), bool) if m is None else np.asarray(m, bool))
            for m in inst_masks
        ]
        results.append({
            "video_id": int(video_id),
            "score": float(score),
            "category_id": int(label) + 1,
            "segmentations": segms,
        })
    return results
