"""Visualize a YTVIS results.json over its videos (reference surface:
tools/visualize_json_results.py); counterpart of the JAX package's
``tools/visualize_json_results.py`` on the port's catalogs, RLE and visualizer:

    python -m vnext_tpu_torch.tools.visualize_json_results --input results.json \
        --dataset ytvis_synthetic_tiny --output vis [--conf-threshold 0.3] [--max-videos 5]

No model runs: nothing here needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
from PIL import Image

from ..data import DatasetCatalog, MetadataCatalog, register_all_ytvis
from ..data.datasets.synthetic import register_synthetic_ytvis
from ..evaluation.rle import rle_decode
from ..utils.visualizer import VideoVisualizer
from .train_net import SYNTHETIC_DATASET


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True, help="results.json (YTVIS format)")
    parser.add_argument("--dataset", required=True, help="registered dataset name")
    parser.add_argument("--output", required=True)
    parser.add_argument("--conf-threshold", type=float, default=0.3)
    parser.add_argument("--max-videos", type=int, default=5)
    args = parser.parse_args(argv)

    register_all_ytvis()
    if args.dataset == SYNTHETIC_DATASET:
        register_synthetic_ytvis(SYNTHETIC_DATASET)
    records = {r["video_id"]: r for r in DatasetCatalog.get(args.dataset)}
    meta = MetadataCatalog.get(args.dataset)
    with open(args.input) as f:
        results = json.load(f)

    by_video = {}
    for i, r in enumerate(results):
        if r["score"] >= args.conf_threshold:
            by_video.setdefault(r["video_id"], []).append((i, r))

    os.makedirs(args.output, exist_ok=True)
    for vid, preds in list(by_video.items())[: args.max_videos]:
        record = records[vid]
        viz = VideoVisualizer(meta.get("thing_classes"))
        vid_dir = os.path.join(args.output, str(vid))
        os.makedirs(vid_dir, exist_ok=True)
        for t, path in enumerate(record["file_names"]):
            frame = np.asarray(Image.open(path).convert("RGB"))
            tids, masks, labels, scores = [], [], [], []
            for inst_id, pred in preds:
                seg = pred["segmentations"][t]
                if seg is None:
                    continue
                tids.append(inst_id)
                masks.append(rle_decode(seg))
                labels.append(pred["category_id"] - 1)
                scores.append(pred["score"])
            if masks:
                frame = viz.draw_frame(
                    frame, tids, labels=np.asarray(labels),
                    scores=np.asarray(scores), masks=np.stack(masks),
                )
            Image.fromarray(frame).save(os.path.join(vid_dir, os.path.basename(path)))
    print(f"Wrote visualizations for {min(len(by_video), args.max_videos)} videos to {args.output}")


if __name__ == "__main__":
    main(sys.argv[1:])
