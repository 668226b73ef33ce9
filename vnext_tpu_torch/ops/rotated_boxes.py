"""Rotated boxes: corner vertices, the exact pairwise IoU and greedy rotated NMS.

Counterpart of ``vnext_tpu.ops.rotated_boxes`` (reference surface:
detectron2/layers/csrc/box_iou_rotated and csrc/nms_rotated). Boxes are
(cx, cy, w, h, angle in degrees), angles counter-clockwise, the reference's
XYWHA_ABS convention.

The intersection of two boxes is the JAX package's fixed-capacity
Sutherland-Hodgman clipping: the first box's 4 corners in 16 vertex slots,
clipped by the second box's 4 edges in turn, each step compacting the
emitted points in edge order (the JAX package's argsort of its slot keys,
here a cumulative-sum scatter to the same positions). It runs on every pair
at once, in f32, ``PAIRS_PER_CHUNK`` pairs at a time so that a 1,000 x 1,000
matrix stays within a few hundred MB of temporaries. Plain torch: none of
this was a Pallas kernel in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .nms import greedy_keep

MAX_VERTS = 16             # a 4-gon clipped by 4 half-planes has <= 8; padded as in the JAX package
PAIRS_PER_CHUNK = 1 << 18  # box pairs clipped at once


def rotated_box_vertices(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 4, 2] corner vertices (CCW) of (cx, cy, w, h, angle_deg) boxes."""
    cx, cy, w, h, a = boxes.unbind(-1)
    theta = a * math.pi / 180.0
    c, s = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    dx = torch.stack([-w / 2, w / 2, w / 2, -w / 2], -1)
    dy = torch.stack([-h / 2, -h / 2, h / 2, h / 2], -1)
    vx = cx[..., None] + dx * c - dy * s
    vy = cy[..., None] + dx * s + dy * c
    return torch.stack([vx, vy], -1)


def _clip_polygon(verts: torch.Tensor, count: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """One clipping step of P polygons at once: verts [P, V, 2] (the first
    ``count`` [P] valid), kept on the left of the edge p1 -> p2 ([P, 2] each).
    Returns (verts [P, V, 2], count [P])."""
    p, v = verts.shape[:2]
    idx = torch.arange(v, device=verts.device)
    valid = idx < count[:, None]
    nxt = torch.where(idx + 1 < count[:, None], idx + 1, torch.zeros_like(idx))
    nxt_v = verts.gather(1, nxt[..., None].expand(-1, -1, 2))
    edge = (p2 - p1)[:, None]
    p1 = p1[:, None]

    def side(pt):
        rel = pt - p1
        return edge[..., 0] * rel[..., 1] - edge[..., 1] * rel[..., 0]

    s_cur, s_nxt = side(verts), side(nxt_v)
    cur_in, nxt_in = s_cur >= -1e-9, s_nxt >= -1e-9
    denom = s_cur - s_nxt
    big = denom.abs() > 1e-12
    t = torch.where(big, s_cur / torch.where(big, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    inter = verts + t[..., None] * (nxt_v - verts)
    # edge i emits its current point (if inside), then the crossing (if the edge crosses):
    # interleaved, slot 2i and 2i + 1, the JAX package's sort keys
    pts = torch.stack([verts, inter], 2).reshape(p, 2 * v, 2)
    flags = torch.stack([valid & cur_in, valid & (cur_in != nxt_in)], 2).reshape(p, 2 * v)
    n_emit = flags.sum(1)
    # emitted points first in slot order, then the others in slot order (the argsort's permutation)
    target = torch.where(flags, flags.cumsum(1) - 1, n_emit[:, None] + (~flags).cumsum(1) - 1)
    out = torch.empty_like(pts).scatter_(1, target[..., None].expand(-1, -1, 2), pts)
    return out[:, :v], n_emit.clamp(max=v)


def _polygon_area(verts: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(verts.shape[1], device=verts.device)
    valid = idx < count[:, None]
    nxt = torch.where(idx + 1 < count[:, None], idx + 1, torch.zeros_like(idx))
    x, y = verts[..., 0], verts[..., 1]
    cross = x * y.gather(1, nxt) - x.gather(1, nxt) * y
    return torch.where(valid, cross, torch.zeros_like(cross)).sum(1).abs() / 2.0


def _intersection_areas(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Intersection areas of P box pairs, each [P, 5]: [P]."""
    subject = rotated_box_vertices(boxes1)                       # [P, 4, 2]
    clipper = rotated_box_vertices(boxes2)
    verts = torch.zeros(boxes1.shape[0], MAX_VERTS, 2, dtype=subject.dtype, device=subject.device)
    verts[:, :4] = subject
    count = torch.full((boxes1.shape[0],), 4, dtype=torch.long, device=subject.device)
    for i in range(4):
        verts, count = _clip_polygon(verts, count, clipper[:, i], clipper[:, (i + 1) % 4])
    return _polygon_area(verts, count)


def pairwise_iou_rotated(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """[N, M] exact IoU between rotated box sets [N, 5] and [M, 5] (f32)."""
    boxes1, boxes2 = boxes1.float(), boxes2.float()
    n, m = boxes1.shape[0], boxes2.shape[0]
    inter = boxes1.new_zeros(n, m)
    rows = max(1, PAIRS_PER_CHUNK // max(m, 1))
    for r0 in range(0, n, rows):
        b1 = boxes1[r0:r0 + rows]
        k = b1.shape[0]
        inter[r0:r0 + k] = _intersection_areas(b1[:, None].expand(k, m, 5).reshape(-1, 5),
                                               boxes2[None].expand(k, m, 5).reshape(-1, 5)).reshape(k, m)
    area1 = boxes1[:, 2] * boxes1[:, 3]
    area2 = boxes2[:, 2] * boxes2[:, 3]
    union = area1[:, None] + area2[None, :] - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-12), torch.zeros_like(union))


def nms_rotated_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy rotated NMS over [N, 5] boxes; the keep mask [N] in the input
    order. Scores tie toward the lower index (a stable sort, as
    ``jnp.argsort``); boxes outside ``valid`` are never kept and suppress
    nothing."""
    n = boxes.shape[0]
    s = scores if valid is None else torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(s, descending=True, stable=True).indices
    sorted_boxes = boxes[order]
    keep_sorted = greedy_keep(pairwise_iou_rotated(sorted_boxes, sorted_boxes) > iou_threshold,
                              torch.ones(n, dtype=torch.bool, device=boxes.device))
    if valid is not None:
        keep_sorted = keep_sorted & valid[order]
    return torch.zeros_like(keep_sorted).index_put((order,), keep_sorted)
