"""Plain-image detection mapper: a COCO-format record -> fixed-shape arrays.

Counterpart of ``vnext_tpu.data.detection_mapper`` (reference surface:
detectron2/data/dataset_mapper.py:20 DatasetMapper for the image
meta-architectures), producing the same numpy arrays from the same draws of
one ``random.Random``: the image resized by its shortest edge (a random
``MIN_SIZE_TRAIN`` and a flip when training, ``MIN_SIZE_TEST`` at test time)
and padded to ``target_size``, its true size, and up to ``max_insts`` ground
truth slots of absolute-xyxy boxes, labels and a validity mask, with
full-resolution bitmasks for Mask R-CNN and keypoints for keypoint R-CNN.
The collation of a train batch (``stack_detection_batch``) comes with R-CNN
training (ROADMAP Queue 1, item 11b).
"""

from __future__ import annotations

import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .dataset_mapper import _load_image, decode_segmentation
from .datasets.builtin_meta import keypoint_flip_indices
from .transforms import ClipAugmentation, transform_keypoint_annotations


class DetectionDatasetMapper:
    def __init__(
        self,
        is_train: bool = True,
        min_sizes: Sequence[int] = (640, 672, 704, 736, 768, 800),
        max_size: int = 1333,
        max_insts: int = 64,
        target_size: Tuple[int, int] = (800, 1344),
        mask_on: bool = False,
        keypoint_on: bool = False,
        num_keypoints: int = 17,
        kp_hflip_indices=None,
        image_loader=_load_image,
    ):
        self.is_train = is_train
        self.aug = ClipAugmentation(
            tuple(min_sizes), max_size, flip=is_train, crop_type=None,
            is_train=is_train,
        )
        self.max_insts = max_insts
        self.target_size = tuple(target_size)
        self.mask_on = mask_on
        self.keypoint_on = keypoint_on
        self.num_keypoints = num_keypoints
        # default flip map is the COCO 17-person layout (builtin_meta.py)
        self.kp_hflip_indices = (
            list(kp_hflip_indices) if kp_hflip_indices is not None else list(keypoint_flip_indices())
        )
        self.image_loader = image_loader

    @classmethod
    def from_config(cls, cfg, is_train: bool = True) -> "DetectionDatasetMapper":
        return cls(
            is_train=is_train,
            min_sizes=tuple(cfg.INPUT.MIN_SIZE_TRAIN) if is_train else (cfg.INPUT.MIN_SIZE_TEST,),
            max_size=cfg.INPUT.MAX_SIZE_TRAIN if is_train else cfg.INPUT.MAX_SIZE_TEST,
            max_insts=cfg.TPU.MAX_INSTANCES,
            target_size=tuple(cfg.TPU.TRAIN_IMAGE_SIZE if is_train else cfg.TPU.TEST_IMAGE_SIZE),
            mask_on=cfg.MODEL.MASK_ON,
            keypoint_on=cfg.MODEL.KEYPOINT_ON,
            num_keypoints=cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS,
        )

    def __call__(self, record: dict, rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        rng = rng or random.Random()
        img = self.image_loader(record["file_name"]) if "file_name" in record else record["image"]
        tfms = self.aug.build(img.shape[0], img.shape[1], rng)
        img = tfms.apply_image(img)
        h, w = img.shape[:2]
        th, tw = self.target_size
        h, w = min(h, th), min(w, tw)
        padded = np.zeros((th, tw, 3), dtype=img.dtype)
        padded[:h, :w] = img[:h, :w]

        k = self.max_insts
        labels = np.zeros((k,), np.int32)
        boxes = np.zeros((k, 4), np.float32)
        boxes[:, 2:] = 1e-4
        valid = np.zeros((k,), bool)
        masks = (
            np.zeros((k, th, tw), bool) if self.mask_on else None
        )
        keypoints = np.zeros((k, self.num_keypoints, 3), np.float32) if self.keypoint_on else None
        oh = record.get("height", img.shape[0])
        ow = record.get("width", img.shape[1])
        slot = 0
        for obj in record.get("annotations", []):
            if slot >= k:
                break
            if obj.get("iscrowd", 0):
                continue
            x, y, bw, bh = obj["bbox"]
            box = tfms.apply_box(np.asarray([[x, y, x + bw, y + bh]], np.float64))[0]
            box = np.clip(box, [0, 0, 0, 0], [tw, th, tw, th])
            if box[2] - box[0] < 1 or box[3] - box[1] < 1:
                continue
            boxes[slot] = box
            labels[slot] = obj["category_id"]
            valid[slot] = True
            if self.mask_on and obj.get("segmentation") is not None:
                m = decode_segmentation(obj["segmentation"], oh, ow)
                m = tfms.apply_image((m * 255).astype(np.uint8)) > 127
                masks[slot, : min(m.shape[0], th), : min(m.shape[1], tw)] = (
                    m[:th, :tw]
                )
            if self.keypoint_on and obj.get("keypoints") is not None:
                keypoints[slot] = transform_keypoint_annotations(
                    obj["keypoints"], tfms, (h, w), self.kp_hflip_indices
                ).astype(np.float32)
            slot += 1

        out = {
            "image": padded,
            "size": np.asarray([h, w], np.int32),
            "labels": labels,
            "boxes": boxes,
            "valid": valid,
            "image_id": record.get("image_id", 0),
        }
        if self.mask_on:
            out["masks"] = masks
        if self.keypoint_on:
            out["keypoints"] = keypoints
        return out
