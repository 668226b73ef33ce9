"""COCO image -> pseudo-clip mapper for IDOL's COCO-pretrain stage.

Counterpart of ``vnext_tpu.data.coco_clip_mapper`` (IDOL's
``COCO_CLIP_DatasetMapper``): one still image becomes a key + reference
pseudo-clip by two independent augmentation draws (one shared draw with
``same_crop``), each with a crop half the time (``rng.random() < 0.5``), from
the same ``random.Random`` in the JAX package's order. Instance identity is
the annotation order (slot + 1); crowd objects are skipped, and objects empty
after the crop stay invalid with ``inst_id`` -1 rather than dropped; masks
are subsampled ``[start::stride]`` as the YTVIS mapper does, and the
reference's ``valid`` is and-ed with the key's. The output is the YTVIS
mapper's fixed-shape padded arrays (``dataset_mapper.py``), so the clip loader
and the trainer take either.

One repair of the JAX package's mapper: a draw larger than the target size
(at the COCO-pretrain yaml's 512x640, a 4:3 image resized to a short side over
512, or a crop over 512 rows) has its image cut to the target, and the JAX
package's masks are not, so it raises a broadcast ``ValueError``; the port
cuts the masks as the image. Wherever the JAX mapper runs, the two agree bit
for bit.
"""

from __future__ import annotations

import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .dataset_mapper import _load_image, decode_segmentation
from .transforms import ClipAugmentation


class CocoClipDatasetMapper:
    def __init__(
        self,
        is_train: bool = True,
        min_sizes: Sequence[int] = (320, 352, 392, 416, 448, 480, 512, 544, 576, 608, 640),
        max_size: int = 768,
        crop_type: Optional[str] = "absolute_range",
        crop_size: Optional[Sequence[float]] = (384, 600),
        same_crop: bool = False,
        max_insts: int = 48,
        target_size: Tuple[int, int] = (480, 864),
        mask_out_stride: int = 4,
        image_loader=_load_image,
    ):
        self.is_train = is_train
        self.same_crop = same_crop
        self.max_insts = max_insts
        self.target_size = tuple(target_size)
        self.mask_out_stride = mask_out_stride
        self.image_loader = image_loader
        # crop applied with prob 0.5, mirroring the reference's np.random.rand() gate
        self.aug_crop = ClipAugmentation(
            min_sizes, max_size, flip=is_train, crop_type=crop_type,
            crop_size=crop_size, is_train=is_train,
        )
        self.aug_nocrop = ClipAugmentation(
            min_sizes, max_size, flip=is_train, crop_type=None, is_train=is_train,
        )

    @classmethod
    def from_config(cls, cfg, is_train: bool = True) -> "CocoClipDatasetMapper":
        return cls(
            is_train=is_train,
            min_sizes=tuple(cfg.INPUT.MIN_SIZE_TRAIN) if is_train else (cfg.INPUT.MIN_SIZE_TEST,),
            max_size=cfg.INPUT.MAX_SIZE_TRAIN if is_train else cfg.INPUT.MAX_SIZE_TEST,
            crop_type=cfg.INPUT.CROP.TYPE if cfg.INPUT.CROP.ENABLED else None,
            crop_size=tuple(cfg.INPUT.CROP.SIZE),
            same_crop=cfg.INPUT.PRETRAIN_SAME_CROP,
            max_insts=cfg.TPU.MAX_INSTANCES,
            target_size=tuple(cfg.TPU.TRAIN_IMAGE_SIZE if is_train else cfg.TPU.TEST_IMAGE_SIZE),
        )

    def _prepare(self, image: np.ndarray, annos, tfms) -> Dict[str, np.ndarray]:
        img = tfms.apply_image(image)
        h, w = img.shape[:2]
        th, tw = self.target_size
        if h > th or w > tw:
            img = img[:th, :tw]
            h, w = img.shape[:2]
        padded = np.zeros((th, tw, 3), np.uint8)
        padded[:h, :w] = img

        k = self.max_insts
        labels = np.zeros((k,), np.int32)
        boxes = np.zeros((k, 4), np.float32)
        boxes[:, 2:] = 1e-4
        valid = np.zeros((k,), bool)
        inst_id = np.full((k,), -1, np.int32)
        masks = np.zeros((k, th // self.mask_out_stride, tw // self.mask_out_stride), bool)

        for slot, obj in enumerate(annos[: k]):
            if obj.get("iscrowd", 0):
                continue
            x, y, bw, bh = obj["bbox"]
            box = tfms.apply_box(np.asarray([[x, y, x + bw, y + bh]], np.float64))[0]
            box[0::2] = np.clip(box[0::2], 0, w)
            box[1::2] = np.clip(box[1::2], 0, h)
            if box[2] - box[0] <= 1e-5 or box[3] - box[1] <= 1e-5:
                continue  # empty after crop: stays invalid (gt_ids=-1 semantics)
            mask_full = decode_segmentation(obj["segmentation"], image.shape[0], image.shape[1])
            # the image's cut to the target size, which the JAX package leaves out (its mapper
            # raises on a draw larger than the target; ROADMAP Queue 3)
            mask_t = tfms.apply_image((mask_full * 255).astype(np.uint8))[:th, :tw] > 127
            if not mask_t.any():
                continue
            mask_pad = np.zeros((th, tw), bool)
            mask_pad[: mask_t.shape[0], : mask_t.shape[1]] = mask_t
            start = self.mask_out_stride // 2
            masks[slot] = mask_pad[start :: self.mask_out_stride, start :: self.mask_out_stride]
            boxes[slot] = [
                (box[0] + box[2]) / 2 / w,
                (box[1] + box[3]) / 2 / h,
                (box[2] - box[0]) / w,
                (box[3] - box[1]) / h,
            ]
            labels[slot] = obj["category_id"]
            valid[slot] = True
            inst_id[slot] = slot + 1

        return {
            "image": padded,
            "size": np.asarray([h, w], np.int32),
            "labels": labels,
            "boxes": boxes,
            "masks_s4": masks,
            "valid": valid,
            "inst_id": inst_id,
        }

    def _draw_tfms(self, h, w, rng):
        aug = self.aug_crop if (self.is_train and rng.random() < 0.5) else self.aug_nocrop
        return aug.build(h, w, rng)

    def __call__(self, record: dict, rng: Optional[random.Random] = None) -> Dict:
        """The pseudo-clip of one image record: ``key`` and ``ref`` arrays, the
        image id as ``video_id``, and frame 0 for both frames."""
        rng = rng or random.Random()
        image = self.image_loader(record["file_name"])
        annos = record.get("annotations", [])
        t_key = self._draw_tfms(record["height"], record["width"], rng)
        t_ref = t_key if self.same_crop else self._draw_tfms(record["height"], record["width"], rng)
        key = self._prepare(image, annos, t_key)
        ref = self._prepare(image, annos, t_ref)
        # key-frame-invalid instances are dropped from both (idol.py:313-323)
        ref["valid"] = ref["valid"] & key["valid"]
        return {"key": key, "ref": ref, "video_id": record.get("image_id", 0),
                "key_frame": 0, "ref_frame": 0}
