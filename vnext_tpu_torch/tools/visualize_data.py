"""Visualize ground-truth annotations / dataloader outputs (reference surface:
tools/visualize_data.py); counterpart of the JAX package's
``tools/visualize_data.py`` on the port's catalogs, mapper and visualizer:

    python -m vnext_tpu_torch.tools.visualize_data --dataset ytvis_synthetic_tiny --output vis \
        [--source annotation|dataloader] [--max-videos 3]

The builtin YTVIS and COCO splits are registered, and the quick-schedule
configs' synthetic set where it is named. No model runs: nothing here needs
the card.
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np
from PIL import Image

from ..data import DatasetCatalog, MetadataCatalog, register_all_coco, register_all_ytvis
from ..data.dataset_mapper import YTVISDatasetMapper, decode_segmentation
from ..data.datasets.synthetic import register_synthetic_ytvis
from ..utils.visualizer import VideoVisualizer, Visualizer
from .train_net import SYNTHETIC_DATASET


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--source", choices=["annotation", "dataloader"], default="annotation")
    parser.add_argument("--max-videos", type=int, default=3)
    args = parser.parse_args(argv)

    register_all_ytvis()
    register_all_coco()
    if args.dataset == SYNTHETIC_DATASET:
        register_synthetic_ytvis(SYNTHETIC_DATASET)
    records = DatasetCatalog.get(args.dataset)
    meta = MetadataCatalog.get(args.dataset)
    os.makedirs(args.output, exist_ok=True)

    if args.source == "dataloader":
        mapper = YTVISDatasetMapper(is_train=True)
        for vi, record in enumerate(records[: args.max_videos]):
            out = mapper(record, random.Random(vi))
            for tag in ("key", "ref"):
                f = out[tag]
                vis = Visualizer(f["image"], meta.get("thing_classes"))
                valid = f["valid"]
                h, w = f["size"]
                boxes = f["boxes"][valid].copy()
                boxes[:, 0::2] *= w
                boxes[:, 1::2] *= h
                xyxy = np.stack(
                    [boxes[:, 0] - boxes[:, 2] / 2, boxes[:, 1] - boxes[:, 3] / 2,
                     boxes[:, 0] + boxes[:, 2] / 2, boxes[:, 1] + boxes[:, 3] / 2], 1
                )
                img = vis.draw_instances(boxes=xyxy, labels=f["labels"][valid])
                Image.fromarray(img).save(os.path.join(args.output, f"{vi}_{tag}.jpg"))
    else:
        for vi, record in enumerate(records[: args.max_videos]):
            viz = VideoVisualizer(meta.get("thing_classes"))
            for t, path in enumerate(record["file_names"][:8]):
                frame = np.asarray(Image.open(path).convert("RGB"))
                annos = record["annotations"][t]
                if annos:
                    masks = np.stack(
                        [decode_segmentation(a["segmentation"], record["height"], record["width"])
                         for a in annos]
                    )
                    frame = viz.draw_frame(
                        frame, [a["id"] for a in annos],
                        labels=np.asarray([a["category_id"] for a in annos]),
                        masks=masks,
                    )
                Image.fromarray(frame).save(os.path.join(args.output, f"{vi}_{t:03d}.jpg"))
    print(f"Wrote visualizations to {args.output}")


if __name__ == "__main__":
    main(sys.argv[1:])
