"""Plain-image detection mapper: a COCO-format record -> fixed-shape arrays.

Counterpart of ``vnext_tpu.data.detection_mapper`` (reference surface:
detectron2/data/dataset_mapper.py:20 DatasetMapper for the image
meta-architectures), producing the same numpy arrays from the same draws of
one ``random.Random``: the image resized by its shortest edge (a random
``MIN_SIZE_TRAIN`` and a flip when training, ``MIN_SIZE_TEST`` at test time)
and padded to ``target_size``, its true size, and up to ``max_insts`` ground
truth slots of absolute-xyxy boxes, labels and a validity mask, with
full-resolution bitmasks for Mask R-CNN and keypoints for keypoint R-CNN;
``stack_detection_batch`` collates a train batch.

A record with a ``sem_seg_file_name`` also gives ``sem_seg``, the semantic
ground truth of PanopticFPN and SemanticSegmentor: the label PNG through the
image's transforms (nearest where they resample), cut as the image is, padded
with ``sem_seg_ignore_value`` to ``target_size`` and taken to a quarter of it
by ``_resize_nearest`` (every fourth row and column). The JAX package's mapper
never makes it, so neither of its semantic architectures can train on a
dataset there (ROADMAP Queue 3, item 6); a record without the file maps
exactly as there.

Each annotation's box is read by its ``bbox_mode``, XYWH_ABS where the record
names none (COCO's and LVIS's records). The JAX package's mapper reads every
box as XYWH, so it trains Pascal VOC's and Cityscapes' XYXY boxes as
``[x0, y0, x0 + x1, y0 + y1]`` (ROADMAP Queue 3, item 7); a record without the
key maps exactly as there.
"""

from __future__ import annotations

import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from ..structures.boxes import BoxMode
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
        sem_seg_ignore_value: int = 255,
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
        self.sem_seg_ignore_value = sem_seg_ignore_value

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
            sem_seg_ignore_value=cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE,
        )

    def draw(self, record: dict, rng: random.Random) -> None:
        """The random draws of one ``__call__`` on ``record`` (its resize and
        flip) and no other work: a resumed loader skips a sample so. The
        record's ``height`` / ``width`` stand for the image's (COCO records
        carry both); without them the image is read."""
        if "height" in record and "width" in record:
            h, w = record["height"], record["width"]
        else:
            h, w = (self.image_loader(record["file_name"]) if "file_name" in record else record["image"]).shape[:2]
        self.aug.build(h, w, rng)

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
            box = tfms.apply_box(np.asarray([_xyxy(obj)], np.float64))[0]
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
        if "sem_seg_file_name" in record:
            with Image.open(record["sem_seg_file_name"]) as im:
                labels = tfms.apply_segmentation(np.asarray(im))
            sem_seg = np.full((th, tw), self.sem_seg_ignore_value, np.int32)
            sem_seg[:h, :w] = labels[:h, :w]
            out["sem_seg"] = _resize_nearest(sem_seg, (th // 4, tw // 4))
        return out


def _xyxy(obj: dict) -> list:
    """An annotation's box as [x0, y0, x1, y1], read by its ``bbox_mode``:
    XYWH_ABS (COCO's, and the mode of a record that names none) or XYXY_ABS."""
    mode = obj.get("bbox_mode", BoxMode.XYWH_ABS)
    if mode == BoxMode.XYWH_ABS:
        x, y, bw, bh = obj["bbox"]
        return [x, y, x + bw, y + bh]
    if mode == BoxMode.XYXY_ABS:
        return list(obj["bbox"])
    raise ValueError(f"bbox_mode {BoxMode(mode).name}: the detection mapper reads XYWH_ABS and XYXY_ABS boxes")


def _resize_nearest(arr: np.ndarray, shape) -> np.ndarray:
    """Nearest resize of a label map to ``shape`` (floor of i * in / out)."""
    oh, ow = shape
    ys = (np.arange(oh) * arr.shape[0] / oh).astype(np.int64).clip(0, arr.shape[0] - 1)
    xs = (np.arange(ow) * arr.shape[1] / ow).astype(np.int64).clip(0, arr.shape[1] - 1)
    return arr[ys][:, xs]


def stack_detection_batch(samples) -> Dict[str, np.ndarray]:
    """Collate mapper outputs into batched arrays (``DetTargets``-ready), with
    ``image_id`` as a list."""
    out = {key: np.stack([s[key] for s in samples]) for key in samples[0] if key != "image_id"}
    out["image_id"] = [s["image_id"] for s in samples]
    return out
