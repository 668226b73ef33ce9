"""Mask containers and polygon rasterization (reference surface:
detectron2/structures/masks.py).

Counterpart of ``vnext_tpu.structures.masks``:

- ``polygons_to_bitmask``: COCO / YTVIS polygons become a dense bool mask
  through PIL's polygon fill (outline and interior), as the JAX package draws
  them, so both packages make the same pixels;
- ``BitMasks``: dense [N, H, W] bool (or float) masks in a tensor on its device;
- ``PolygonMasks``, ``polygon_area``, ``rasterize_polygons_within_box``: the
  ragged polygons stay on the host in numpy, as in JAX, until they are
  rasterized into fixed-shape masks;
- ``ROIMasks``: [N, M, M] per-box masks, pasted into the image by
  ``ops/mask_ops.paste_masks_in_image``;
- ``mask_iou_pairwise``: [N, M] IoU of two stacks of binary masks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def polygons_to_bitmask(polygons: Sequence[np.ndarray], height: int, width: int) -> np.ndarray:
    """Rasterize COCO-style polygons ([x0, y0, x1, y1, ...] each) into an
    [height, width] bool mask; polygons of fewer than 3 points are skipped."""
    from PIL import Image, ImageDraw

    if len(polygons) == 0:
        return np.zeros((height, width), dtype=bool)
    img = Image.new("L", (width, height), 0)
    draw = ImageDraw.Draw(img)
    for p in polygons:
        p = np.asarray(p, dtype=np.float64).reshape(-1, 2)
        if len(p) < 3:
            continue
        draw.polygon([tuple(xy) for xy in p], outline=1, fill=1)
    return np.array(img, dtype=bool)


class BitMasks:
    """Dense [N, H, W] masks, ``tensor`` on its device."""

    def __init__(self, tensor):
        tensor = torch.as_tensor(tensor)
        if tensor.dim() != 3:
            raise ValueError(f"BitMasks tensor must be (N, H, W), got {tuple(tensor.shape)}")
        self.tensor = tensor

    @property
    def device(self) -> torch.device:
        return self.tensor.device

    @property
    def image_size(self) -> Tuple[int, int]:
        return tuple(self.tensor.shape[1:])

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __getitem__(self, item) -> "BitMasks":
        t = self.tensor[item]
        return BitMasks(t[None] if t.dim() == 2 else t)

    def to(self, device) -> "BitMasks":
        return BitMasks(self.tensor.to(device))

    def nonempty(self) -> torch.Tensor:
        return self.tensor.reshape(len(self), -1).bool().any(-1)

    def get_bounding_boxes(self) -> torch.Tensor:
        """Tight [N, 4] f32 xyxy boxes around each mask; an empty mask's box is zeros."""
        masks = self.tensor.bool()
        _, h, w = masks.shape
        any_col, any_row = masks.any(1), masks.any(2)                    # [N, W], [N, H]
        xs = torch.arange(w, device=masks.device)
        ys = torch.arange(h, device=masks.device)
        big = torch.iinfo(torch.int32).max
        x1 = torch.where(any_col, xs, big).amin(1)
        x2 = torch.where(any_col, xs + 1, 0).amax(1)
        y1 = torch.where(any_row, ys, big).amin(1)
        y2 = torch.where(any_row, ys + 1, 0).amax(1)
        boxes = torch.stack([x1, y1, x2, y2], -1).float()
        return torch.where(any_col.any(1)[:, None], boxes, 0.0)

    @staticmethod
    def cat(masks_list: List["BitMasks"]) -> "BitMasks":
        return BitMasks(torch.cat([m.tensor for m in masks_list]))

    @staticmethod
    def from_polygon_masks(polygon_masks, height: int, width: int, device="cpu") -> "BitMasks":
        """Each instance's polygons rasterized at (height, width), on ``device``."""
        if isinstance(polygon_masks, PolygonMasks):
            polygon_masks = polygon_masks.polygons
        masks = [polygons_to_bitmask(p, height, width) for p in polygon_masks]
        if not masks:
            return BitMasks(torch.zeros((0, height, width), dtype=torch.bool, device=device))
        return BitMasks(torch.from_numpy(np.stack(masks)).to(device))

    @staticmethod
    def from_roi_masks(roi_masks: "ROIMasks", boxes: torch.Tensor, height: int, width: int) -> "BitMasks":
        return roi_masks.to_bitmasks(boxes, height, width)

    def __repr__(self) -> str:
        return f"BitMasks(shape={tuple(self.tensor.shape)}, dtype={self.tensor.dtype}, device={self.device})"


def polygon_area(x: np.ndarray, y: np.ndarray) -> float:
    """The shoelace formula's area of a polygon."""
    return 0.5 * np.abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def rasterize_polygons_within_box(polygons: Sequence[np.ndarray], box: np.ndarray, mask_size: int) -> np.ndarray:
    """A [mask_size, mask_size] bool mask of the polygons cut to ``box``
    (xyxy) and scaled to the mask, the box's extent at least 0.1 pixel: Mask
    R-CNN's training target."""
    box = np.asarray(box, dtype=np.float64)
    w, h = box[2] - box[0], box[3] - box[1]
    out = []
    for p in polygons:
        p = np.asarray(p, dtype=np.float64).copy()
        p[0::2] = (p[0::2] - box[0]) * (mask_size / max(w, 0.1))
        p[1::2] = (p[1::2] - box[1]) * (mask_size / max(h, 0.1))
        out.append(p)
    return polygons_to_bitmask(out, mask_size, mask_size)


class PolygonMasks:
    """Each instance's polygons (a list of float64 [x0, y0, ...] arrays), on
    the host: ragged, rasterized into fixed-shape masks before the card sees them."""

    def __init__(self, polygons: List[List[np.ndarray]]):
        if not isinstance(polygons, list):
            raise ValueError(f"PolygonMasks expects list[list[ndarray]], got {type(polygons)}")

        def process(per_instance):
            if not isinstance(per_instance, list):
                raise ValueError(f"Expect a list of polygons per instance, got {type(per_instance)}")
            per_instance = [np.asarray(p, dtype=np.float64).reshape(-1) for p in per_instance]
            for p in per_instance:
                if len(p) % 2 != 0 or len(p) < 6:
                    raise ValueError(f"Cannot create a polygon from {len(p)} coordinates.")
            return per_instance

        self.polygons: List[List[np.ndarray]] = [process(p) for p in polygons]

    def get_bounding_boxes(self) -> np.ndarray:
        """Tight [N, 4] f32 xyxy boxes around each instance's polygons."""
        boxes = np.zeros((len(self.polygons), 4), dtype=np.float32)
        for idx, per_instance in enumerate(self.polygons):
            minxy = np.full(2, np.inf, dtype=np.float32)
            maxxy = np.zeros(2, dtype=np.float32)
            for p in per_instance:
                coords = p.reshape(-1, 2).astype(np.float32)
                minxy = np.minimum(minxy, coords.min(axis=0))
                maxxy = np.maximum(maxxy, coords.max(axis=0))
            boxes[idx, :2] = minxy
            boxes[idx, 2:] = maxxy
        return boxes

    def nonempty(self) -> np.ndarray:
        return np.asarray([len(p) > 0 for p in self.polygons], dtype=bool)

    def __getitem__(self, item) -> "PolygonMasks":
        if isinstance(item, int):
            return PolygonMasks([self.polygons[item]])
        if isinstance(item, slice):
            return PolygonMasks(self.polygons[item])
        item = np.asarray(item)
        if item.dtype == bool:
            item = np.nonzero(item)[0]
        return PolygonMasks([self.polygons[int(i)] for i in item.tolist()])

    def __iter__(self):
        return iter(self.polygons)

    def __len__(self) -> int:
        return len(self.polygons)

    def __repr__(self) -> str:
        return f"PolygonMasks(num_instances={len(self.polygons)})"

    def crop_and_resize(self, boxes: np.ndarray, mask_size: int) -> np.ndarray:
        """[N, mask_size, mask_size] bool training targets, one per box."""
        boxes = np.asarray(boxes)
        if len(boxes) != len(self):
            raise ValueError(f"{len(boxes)} boxes for {len(self)} instances")
        if len(self) == 0:
            return np.zeros((0, mask_size, mask_size), dtype=bool)
        return np.stack([rasterize_polygons_within_box(p, b, mask_size) for p, b in zip(self.polygons, boxes)])

    def area(self) -> np.ndarray:
        return np.asarray([sum(polygon_area(p[0::2], p[1::2]) for p in pi) for pi in self.polygons],
                          dtype=np.float64)

    @staticmethod
    def cat(polymasks_list: List["PolygonMasks"]) -> "PolygonMasks":
        if not polymasks_list:
            raise ValueError("PolygonMasks.cat of an empty list")
        return PolygonMasks([p for pm in polymasks_list for p in pm.polygons])


class ROIMasks:
    """[N, M, M] masks, one per box; ``to_bitmasks`` pastes them into the image."""

    def __init__(self, tensor):
        tensor = torch.as_tensor(tensor)
        if tensor.dim() != 3:
            raise ValueError("ROIMasks must take a masks of 3 dimension.")
        self.tensor = tensor

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __getitem__(self, item) -> "ROIMasks":
        t = self.tensor[item]
        if t.dim() != 3:
            raise ValueError(f"Indexing ROIMasks with {item} gives shape {tuple(t.shape)}")
        return ROIMasks(t)

    def __repr__(self) -> str:
        return f"ROIMasks(num_instances={len(self)})"

    def to_bitmasks(self, boxes: torch.Tensor, height: int, width: int, threshold: float = 0.5) -> BitMasks:
        """[N, height, width] bool masks: each pasted into its box (xyxy in the
        image) and thresholded, on the masks' device."""
        from ..ops.mask_ops import paste_masks_in_image

        return BitMasks(paste_masks_in_image(self.tensor, boxes, (height, width), threshold=threshold))


def mask_iou_pairwise(masks1: torch.Tensor, masks2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """[N, M] IoU of two stacks of binary masks [N, ...] and [M, ...], in f32,
    (intersection + eps) / (union + eps), as the reference tracker's ``mask_iou``."""
    m1 = masks1.reshape(masks1.shape[0], -1).float()
    m2 = masks2.reshape(masks2.shape[0], -1).float()
    inter = m1 @ m2.T
    union = m1.sum(-1)[:, None] + m2.sum(-1)[None, :] - inter
    return (inter + eps) / (union + eps)
