"""YTVIS clip mapper: a video record -> fixed-shape padded training arrays.

Counterpart of ``vnext_tpu.data.dataset_mapper`` (IDOL's key-frame +
reference-frame sampling and clip-level augmentation), producing the same
fixed-capacity numpy arrays from the same draws of one ``random.Random``:

    key_image/ref_image: [H, W, 3] uint8, padded to a fixed target size
    key_size/ref_size:   (h, w) true augmented size
    labels/boxes/masks_s4/valid/inst_id: padded to ``max_insts`` slots

The arrays stay numpy: the trainer moves a collated batch to the card and
normalizes it there (``engine/trainer.py``'s ``batch_to_model_inputs``).
"""

from __future__ import annotations

import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from ..evaluation.rle import rle_decode
from ..structures.masks import polygons_to_bitmask
from .transforms import ClipAugmentation, TransformList


def _load_image(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def decode_segmentation(segm, height: int, width: int) -> np.ndarray:
    """Polygons (list) or uncompressed RLE dict -> bool mask."""
    if isinstance(segm, dict):
        return rle_decode(segm)
    polys = [np.asarray(p, dtype=np.float64) for p in segm]
    return polygons_to_bitmask(polys, height, width)


class YTVISDatasetMapper:
    def __init__(
        self,
        is_train: bool = True,
        min_sizes: Sequence[int] = (320, 352, 392, 416, 448, 480, 512, 544, 576, 608, 640),
        max_size: int = 768,
        crop_type: Optional[str] = "absolute_range",
        crop_size: Optional[Sequence[float]] = (384, 600),
        sampling_frame_range: int = 10,
        max_insts: int = 48,
        target_size: Tuple[int, int] = (480, 864),
        mask_out_stride: int = 4,
        image_loader=_load_image,
    ):
        self.is_train = is_train
        self.aug = ClipAugmentation(
            min_sizes, max_size,
            flip=is_train,
            crop_type=crop_type if is_train else None,
            crop_size=crop_size,
            is_train=is_train,
        )
        self.sampling_frame_range = sampling_frame_range
        self.max_insts = max_insts
        self.target_size = tuple(target_size)
        self.mask_out_stride = mask_out_stride
        self.image_loader = image_loader

    @classmethod
    def from_config(cls, cfg, is_train: bool = True) -> "YTVISDatasetMapper":
        return cls(
            is_train=is_train,
            min_sizes=tuple(cfg.INPUT.MIN_SIZE_TRAIN) if is_train else (cfg.INPUT.MIN_SIZE_TEST,),
            max_size=cfg.INPUT.MAX_SIZE_TRAIN if is_train else cfg.INPUT.MAX_SIZE_TEST,
            crop_type=cfg.INPUT.CROP.TYPE if cfg.INPUT.CROP.ENABLED else None,
            crop_size=tuple(cfg.INPUT.CROP.SIZE),
            sampling_frame_range=cfg.INPUT.SAMPLING_FRAME_RANGE,
            max_insts=cfg.TPU.MAX_INSTANCES,
            target_size=tuple(cfg.TPU.TRAIN_IMAGE_SIZE if is_train else cfg.TPU.TEST_IMAGE_SIZE),
            mask_out_stride=cfg.MODEL.IDOL.MASK_STRIDE if "IDOL" in cfg.MODEL else 4,
        )

    # ------------------------------------------------------------------ frames
    def sample_frames(self, video_length: int, rng: random.Random) -> Tuple[int, int]:
        """Key frame uniform; reference frame within +-sampling_frame_range of it."""
        key = rng.randrange(video_length)
        lo = max(0, key - self.sampling_frame_range)
        hi = min(video_length - 1, key + self.sampling_frame_range)
        candidates = [i for i in range(lo, hi + 1) if i != key] or [key]
        ref = rng.choice(candidates)
        return key, ref

    def _prepare_frame(
        self, record: dict, frame_idx: int, tfms: TransformList, id_slots: Dict[int, int]
    ) -> Dict[str, np.ndarray]:
        img = self.image_loader(record["file_names"][frame_idx])
        img = tfms.apply_image(img)
        h, w = img.shape[:2]
        th, tw = self.target_size
        padded = np.zeros((th, tw, 3), dtype=np.uint8)
        padded[:h, :w] = img

        k = self.max_insts
        labels = np.zeros((k,), np.int32)
        boxes = np.zeros((k, 4), np.float32)
        boxes[:, 2:] = 1e-4  # degenerate but nonzero padding boxes
        valid = np.zeros((k,), bool)
        inst_id = np.full((k,), -1, np.int32)
        masks = np.zeros((k, th // self.mask_out_stride, tw // self.mask_out_stride), bool)

        annos = record["annotations"][frame_idx] if record.get("annotations") else []
        for obj in annos:
            slot = id_slots.get(obj["id"])
            if slot is None or slot >= k:
                continue
            x, y, bw, bh = obj["bbox"]
            box = np.asarray([[x, y, x + bw, y + bh]], np.float64)
            box = tfms.apply_box(box)[0]
            box[0::2] = np.clip(box[0::2], 0, w)
            box[1::2] = np.clip(box[1::2], 0, h)
            if box[2] <= box[0] or box[3] <= box[1]:
                continue
            mask_full = decode_segmentation(obj["segmentation"], record["height"], record["width"])
            # geometric transforms on the dense mask: apply via PIL for resize/flip/crop
            mask_t = tfms.apply_image((mask_full * 255).astype(np.uint8)) > 127
            mask_pad = np.zeros((th, tw), bool)
            mask_pad[: mask_t.shape[0], : mask_t.shape[1]] = mask_t
            start = self.mask_out_stride // 2
            masks[slot] = mask_pad[start :: self.mask_out_stride, start :: self.mask_out_stride]

            cx = (box[0] + box[2]) / 2 / w
            cy = (box[1] + box[3]) / 2 / h
            bw_n = (box[2] - box[0]) / w
            bh_n = (box[3] - box[1]) / h
            boxes[slot] = [cx, cy, bw_n, bh_n]
            labels[slot] = obj["category_id"]
            valid[slot] = True
            inst_id[slot] = obj["id"]

        return {
            "image": padded,
            "size": np.asarray([h, w], np.int32),
            "labels": labels,
            "boxes": boxes,
            "masks_s4": masks,
            "valid": valid,
            "inst_id": inst_id,
        }

    def __call__(self, record: dict, rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        rng = rng or random.Random()
        key_idx, ref_idx = (
            self.sample_frames(record["length"], rng) if self.is_train else (0, 0)
        )
        tfms = self.aug.build(record["height"], record["width"], rng)

        # assign shared instance slots by annotation id over both frames,
        # keyed on key-frame presence first (key-frame absentees may drop out)
        id_slots: Dict[int, int] = {}
        for fi in (key_idx, ref_idx):
            for obj in (record["annotations"][fi] if record.get("annotations") else []):
                if obj["id"] not in id_slots and len(id_slots) < self.max_insts:
                    id_slots[obj["id"]] = len(id_slots)

        key = self._prepare_frame(record, key_idx, tfms, id_slots)
        ref = self._prepare_frame(record, ref_idx, tfms, id_slots)

        # instances invalid on the key frame are dropped from both frames, as IDOL's targets do
        ref["valid"] = ref["valid"] & key["valid"]
        return {
            "key": key,
            "ref": ref,
            "video_id": record.get("video_id", 0),
            "key_frame": key_idx,
            "ref_frame": ref_idx,
        }
