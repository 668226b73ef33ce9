"""COCO run-length encoding of masks (numpy; no pycocotools).

Counterpart of ``vnext_tpu.evaluation.rle``: column-major run lengths, starting
with a run of zeros, compressed to ASCII with COCO's 5-bit delta scheme, so that
``results.json`` is byte-compatible with pycocotools' output; and the decode,
area and IoU the evaluator and the mapper read RLE ground truth with.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

RLE = Dict[str, Union[List[int], str, bytes]]


def mask_to_counts(mask: np.ndarray) -> List[int]:
    """Binary HxW mask -> column-major run lengths, starting with a zero-run."""
    flat = np.asarray(mask, dtype=np.uint8).flatten(order="F")
    if flat.size == 0:
        return [0]
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return runs


def counts_to_mask(counts: List[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F").astype(bool)


def compress_counts(counts: List[int]) -> str:
    """COCO compression: 5-bit groups, delta-coded from counts[i-2]."""
    out = []
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c5 = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c5 & 0x10)) or (x == -1 and (c5 & 0x10)))
            if more:
                c5 |= 0x20
            out.append(chr(c5 + 48))
    return "".join(out)


def decompress_counts(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_counts(rle: RLE) -> List[int]:
    """The run lengths of an RLE, compressed or not."""
    counts = rle["counts"]
    return decompress_counts(counts) if isinstance(counts, (str, bytes)) else list(counts)


def rle_encode(mask: np.ndarray) -> RLE:
    """HxW bool mask -> compressed COCO RLE dict."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": compress_counts(mask_to_counts(mask))}


def rle_decode(rle: RLE) -> np.ndarray:
    h, w = rle["size"]
    return counts_to_mask(rle_counts(rle), h, w)


def rle_area(rle: RLE) -> int:
    return int(sum(rle_counts(rle)[1::2]))


def rle_iou(rle1: RLE, rle2: RLE) -> float:
    """IoU of two RLE masks (decoded; 0 where both are empty)."""
    m1 = rle_decode(rle1)
    m2 = rle_decode(rle2)
    inter = np.logical_and(m1, m2).sum()
    union = np.logical_or(m1, m2).sum()
    return float(inter) / float(union) if union > 0 else 0.0
