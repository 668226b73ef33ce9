"""Batched padded images (reference surface: detectron2/structures/image_list.py:11).

Counterpart of ``vnext_tpu.structures.image_list``: ``tensor`` [N, H, W, C]
padded images and ``image_sizes`` [N, 2] the true (h, w) of each. The layout is
NHWC, the JAX package's and the models' input; ``from_arrays`` pads to a shared
shape, or to exactly ``target_size`` (the fixed serving shape).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _round_up(x: int, divisor: int) -> int:
    return ((x + divisor - 1) // divisor) * divisor


class ImageList:
    """tensor: [N, H, W, C] padded images; image_sizes: [N, 2] true (h, w) per image."""

    def __init__(self, tensor: torch.Tensor, image_sizes):
        self.tensor = tensor
        self.image_sizes = torch.as_tensor(image_sizes, dtype=torch.int32, device=tensor.device)

    def __len__(self) -> int:
        return self.tensor.shape[0]

    @property
    def padded_size(self) -> Tuple[int, int]:
        return self.tensor.shape[1], self.tensor.shape[2]

    def padding_mask(self) -> torch.Tensor:
        """[N, H, W] bool, True on padding pixels."""
        n, h, w = self.tensor.shape[:3]
        dev = self.tensor.device
        ys = torch.arange(h, device=dev)[None, :, None]
        xs = torch.arange(w, device=dev)[None, None, :]
        hs = self.image_sizes[:, 0][:, None, None]
        ws = self.image_sizes[:, 1][:, None, None]
        return ~((ys < hs) & (xs < ws))

    @staticmethod
    def from_arrays(images: Sequence[np.ndarray], size_divisibility: int = 32, pad_value: float = 0.0,
                    target_size: Optional[Tuple[int, int]] = None) -> "ImageList":
        """Pad HWC images to a common (H, W): the largest rounded up to
        ``size_divisibility``, or exactly ``target_size`` (an image larger than
        it raises). f32, on the CPU."""
        if not images:
            raise ValueError("ImageList.from_arrays: no images")
        image_sizes = [(int(im.shape[0]), int(im.shape[1])) for im in images]
        if target_size is not None:
            max_h, max_w = target_size
        else:
            max_h = max(s[0] for s in image_sizes)
            max_w = max(s[1] for s in image_sizes)
            if size_divisibility > 1:
                max_h, max_w = _round_up(max_h, size_divisibility), _round_up(max_w, size_divisibility)
        batch = np.full((len(images), max_h, max_w, images[0].shape[2]), pad_value, dtype=np.float32)
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            if h > max_h or w > max_w:
                raise ValueError(f"Image ({h}, {w}) larger than padded size ({max_h}, {max_w})")
            batch[i, :h, :w] = im
        return ImageList(torch.from_numpy(batch), image_sizes)
