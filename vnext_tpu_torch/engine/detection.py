"""Image-detection serving for the Detectron2 meta-architectures: the test
loader, the per-image runner and the ``--eval-only`` evaluation.

Counterpart of ``vnext_tpu.engine.detection`` (reference surface:
tools/train_net.py and plain_train_net.py do_test, engine/defaults.py
DefaultPredictor), serving only: each image is resized by its shortest edge,
normalized and padded to ``TPU.TEST_IMAGE_SIZE`` (800 x 1344 in the COCO
configs), run through the model's ``inference`` under ``torch.no_grad()`` on
the model's device, and its detections rescaled to the original image, with
the masks pasted there, for the evaluator. The JAX package jits one forward
of that fixed size; here the module runs eagerly on the same padded input.

Of the image meta-architectures only ``GeneralizedRCNN`` is ported; the
others raise in ``models.build_model`` naming their ROADMAP item, and
training any of them is ROADMAP Queue 1, item 11b onwards.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np
import torch

from ..checkpoint.checkpointer import load_weights
from ..data.catalog import DatasetCatalog
from ..data.dataset_mapper import _load_image
from ..data.transforms import ClipAugmentation
from ..evaluation.ytvis_eval import build_evaluator
from ..models import DETECTRON2_ARCHITECTURES, build_model
from ..ops.mask_ops import paste_masks_in_image

# the image meta-architectures (the JAX package's capability table's keys), which the entry point
# sends here; only GeneralizedRCNN is ported
_ARCH = ("GeneralizedRCNN", *DETECTRON2_ARCHITECTURES)


def build_detection_test_loader(dataset_name: str) -> List[dict]:
    """Per-image records for evaluation (reference build.py:469)."""
    return DatasetCatalog.get(dataset_name)


class DetectionInference:
    """Per-image runner: resize -> normalize and pad -> forward -> rescale to
    the original coordinates (numpy outputs: boxes, scores, classes, valid, and
    masks [D, H, W] bool with ``MODEL.MASK_ON``). ``model`` is in eval mode on
    its device; the image's normalization, the forward and the mask pasting
    run there."""

    def __init__(self, cfg, model: torch.nn.Module):
        self.arch = cfg.MODEL.META_ARCHITECTURE
        if self.arch != "GeneralizedRCNN":
            raise NotImplementedError(f"DetectionInference for {self.arch!r}: only GeneralizedRCNN is ported "
                                      "(ROADMAP Queue 1, item 11)")
        self.model = model
        self.device = next(model.parameters()).device
        # DetectionDatasetMapper's test-time resize (its targets are not needed to serve)
        self.resize = ClipAugmentation((cfg.INPUT.MIN_SIZE_TEST,), cfg.INPUT.MAX_SIZE_TEST, flip=False,
                                       crop_type=None, is_train=False)
        self.mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32, device=self.device)
        self.std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32, device=self.device)
        self.target_size = tuple(cfg.TPU.TEST_IMAGE_SIZE)

    def preprocess(self, record: dict):
        """(images [1, th, tw, 3] normalized and padded with zeros, sizes [1, 2],
        both on the model's device; the resized (h, w); the original (h, w))."""
        img = _load_image(record["file_name"]) if "file_name" in record else record["image"]
        oh, ow = record.get("height", img.shape[0]), record.get("width", img.shape[1])
        resized = self.resize.build(img.shape[0], img.shape[1], random.Random(0)).apply_image(img)
        th, tw = self.target_size
        h, w = min(resized.shape[0], th), min(resized.shape[1], tw)
        pixels = torch.from_numpy(np.array(resized[:h, :w])).to(self.device)
        images = torch.zeros((1, th, tw, 3), dtype=torch.float32, device=self.device)
        images[0, :h, :w] = (pixels.float() - self.mean) / self.std
        sizes = torch.tensor([[h, w]], dtype=torch.int32, device=self.device)
        return images, sizes, (h, w), (oh, ow)

    @torch.no_grad()
    def __call__(self, record: dict) -> dict:
        images, sizes, (h, w), (oh, ow) = self.preprocess(record)
        out = self.model.inference(images, sizes)
        sx, sy = ow / max(w, 1), oh / max(h, 1)
        boxes = out["boxes"][0] * torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=self.device)
        result = {"boxes": boxes, "scores": out["scores"][0], "classes": out["classes"][0],
                  "valid": out["valid"][0]}
        if "mask_probs" in out:
            result["masks"] = paste_masks_in_image(out["mask_probs"][0], boxes, (oh, ow))
        return {k: v.cpu().numpy() for k, v in result.items()}


def _resize_nearest(arr: np.ndarray, shape) -> np.ndarray:
    """Nearest resize of a label map to ``shape`` (floor of i * in / out)."""
    oh, ow = shape
    ys = (np.arange(oh) * arr.shape[0] / oh).astype(np.int64).clip(0, arr.shape[0] - 1)
    xs = (np.arange(ow) * arr.shape[1] / ow).astype(np.int64).clip(0, arr.shape[1] - 1)
    return arr[ys][:, xs]


def do_eval_detection(cfg, model: Optional[torch.nn.Module] = None,
                      device: Optional[torch.device] = None) -> Dict[str, dict]:
    """--eval-only for the image meta-architectures (plain_train_net.py
    do_test): {dataset: the evaluator's results} for each ``DATASETS.TEST``
    dataset. Without ``model`` one is built from ``cfg`` on ``device`` with
    seeded weights, then ``MODEL.WEIGHTS`` loaded if set. The entry point
    (``tools/train_net.run``) holds the first dataset's results to
    ``TEST.EXPECTED_RESULTS``."""
    if model is None:
        model = build_model(cfg, device=device if device is not None else "cuda", seed=0)
        if cfg.MODEL.WEIGHTS:
            load_weights(cfg.MODEL.WEIGHTS, model)
    model.eval()
    runner = DetectionInference(cfg, model)
    results = {}
    for dataset_name in cfg.DATASETS.TEST:
        evaluator = build_evaluator(cfg, dataset_name)
        evaluator.reset()
        for record in build_detection_test_loader(dataset_name):
            evaluator.process([record], [runner(record)])
        results[dataset_name] = evaluator.evaluate()
    return results
