"""Point sampling for Mask2Former's point-rend-style mask losses.

Counterpart of ``vnext_tpu.ops.point_sample``: the mask BCE and dice are taken
on ``num_points`` points per mask instead of the dense stride-4 masks. Of the
points, 75% are the most uncertain (|logit| smallest) of 3x as many uniform
draws and the rest are uniform draws. ``point_sample`` is the JAX package's
four-corner formula (``grid_sample`` with ``align_corners=False``; a corner
outside the map adds zero) in plain gathers. The draws come from an explicit
``torch.Generator``, and each step of the recipe is a function of its own:
``uniform_coords`` draws, ``uncertain_coords`` picks, ``mask_losses_at`` takes
the losses at given coordinates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def point_sample(inputs: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of [N, H, W] maps at [N, P, 2] normalized (x, y)
    coordinates in [0, 1]. Returns [N, P] in ``inputs``' dtype."""
    n, h, w = inputs.shape
    x = coords[..., 0] * w - 0.5
    y = coords[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = x - x0, y - y0
    flat = inputs.reshape(n, h * w)
    out = torch.zeros(coords.shape[:-1], dtype=inputs.dtype, device=inputs.device)
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        wgt = (tx if dx else 1 - tx) * (ty if dy else 1 - ty)
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        out = out + torch.gather(flat, 1, idx) * (wgt * inside).to(inputs.dtype)
    return out


def uniform_coords(n: int, count: int, generator: torch.Generator, device) -> torch.Tensor:
    """[n, count, 2] uniform draws in [0, 1) from ``generator``."""
    return torch.rand(n, count, 2, generator=generator, device=device)


def uncertain_coords(mask_logits: torch.Tensor, candidates: torch.Tensor, count: int) -> torch.Tensor:
    """The ``count`` candidates [N, C, 2] where the logits [N, H, W] are least
    certain (-|logit| largest), in ``lax.top_k``'s order: descending, ties to
    the lower index."""
    scores = -point_sample(mask_logits, candidates).abs()
    top = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :count]
    return torch.gather(candidates, 1, top[..., None].expand(-1, -1, 2))


def get_uncertain_point_coords_with_randomness(
        mask_logits: torch.Tensor, num_points: int, generator: torch.Generator,
        oversample_ratio: float = 3.0, importance_sample_ratio: float = 0.75) -> torch.Tensor:
    """[N, num_points, 2]: the uncertain picks of ``num_points * oversample_ratio``
    uniform draws, then uniform draws for the rest."""
    n = mask_logits.shape[0]
    candidates = uniform_coords(n, int(num_points * oversample_ratio), generator, mask_logits.device)
    n_uncertain = int(importance_sample_ratio * num_points)
    picked = uncertain_coords(mask_logits, candidates, n_uncertain)
    if num_points > n_uncertain:
        extra = uniform_coords(n, num_points - n_uncertain, generator, mask_logits.device)
        picked = torch.cat([picked, extra], 1)
    return picked


def mask_losses_at(src_masks: torch.Tensor, tgt_masks: torch.Tensor, coords: torch.Tensor,
                   valid: torch.Tensor, num_masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BCE, dice) of the mask logits [N, H, W] against the 0/1 targets [N, H, W]
    at [N, P, 2] coordinates, each row weighed by ``valid`` [N], summed and
    divided by ``num_masks``."""
    src = point_sample(src_masks, coords)
    with torch.no_grad():
        tgt = point_sample(tgt_masks, coords)
    w = valid.to(src.dtype)
    bce = ((F.softplus(src) - src * tgt).mean(1) * w).sum() / num_masks
    probs = torch.sigmoid(src)
    numer = 2 * (probs * tgt).sum(1)
    denom = probs.sum(1) + tgt.sum(1)
    dice = ((1 - (numer + 1) / (denom + 1)) * w).sum() / num_masks
    return bce, dice


def sampled_mask_losses(src_masks: torch.Tensor, tgt_masks: torch.Tensor, valid: torch.Tensor,
                        num_masks: torch.Tensor, num_points: int = 12544,
                        generator: Optional[torch.Generator] = None,
                        oversample_ratio: float = 3.0,
                        importance_sample_ratio: float = 0.75) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss_mask, loss_dice) on points drawn by the recipe above from
    ``generator`` (a generator seeded 0 on the masks' device without one)."""
    if generator is None:
        generator = torch.Generator(device=src_masks.device).manual_seed(0)
    with torch.no_grad():
        coords = get_uncertain_point_coords_with_randomness(
            src_masks.detach(), num_points, generator, oversample_ratio, importance_sample_ratio)
    return mask_losses_at(src_masks, tgt_masks, coords, valid, num_masks)
