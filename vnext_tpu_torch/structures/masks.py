"""Polygon rasterization for the host data pipeline.

Counterpart of ``vnext_tpu.structures.masks.polygons_to_bitmask``: COCO / YTVIS
polygons become a dense bool mask through PIL's polygon fill (outline and
interior), as the JAX package draws them, so both packages make the same pixels.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


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
