"""Optimizer, learning-rate schedule and gradient clipping of the IDOL recipe.

Counterpart of ``vnext_tpu.solver.build``: AdamW with the backbone at a 0.1
learning-rate multiplier, WarmupMultiStepLR, and clipping by the global
gradient norm over the whole model (``full_model``), which is what every IDOL
config in ``configs/`` sets. The JAX package masks parameter
trees with optax; here the same path substrings sort the port's parameter
names (which follow the flax tree) into groups.

Two points of parity with the JAX package:

- optax counts updates from 0, so the first update uses the schedule's step 0;
  ``LambdaLR`` sets that rate at construction and advances it after each step.
- The JAX chain clips by the global norm *before* it zeroes the frozen
  parameters' updates, so that norm counts the gradients of the frozen
  parameters too (FrozenBN weights, biases and statistics, the stem, layer1).
  Every parameter here requires a gradient, the clip runs over all of them, and
  the frozen ones are in no parameter group, so the optimizer never moves them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn


def is_frozen(name: str) -> bool:
    """Parameters the recipe never trains: FrozenBN tensors anywhere in the
    backbone, and the backbone's stem and layer1."""
    if "backbone" not in name:
        return False
    if any(s in name for s in ("bn1", "bn2", "bn3", "downsample_bn", "running_")):
        return True
    return ("conv1" in name and "layer" not in name) or "layer1_" in name


def is_backbone(name: str) -> bool:
    return "backbone" in name


def frozen_mask(model: nn.Module) -> Dict[str, bool]:
    return {name: is_frozen(name) for name, _ in model.named_parameters()}


def backbone_mask(model: nn.Module) -> Dict[str, bool]:
    return {name: is_backbone(name) for name, _ in model.named_parameters()}


def build_lr_schedule(cfg) -> Callable[[int], float]:
    """step -> learning rate: linear warmup, then multi-step decay."""
    if cfg.SOLVER.LR_SCHEDULER_NAME != "WarmupMultiStepLR":
        raise NotImplementedError(f"the port has WarmupMultiStepLR only, got {cfg.SOLVER.LR_SCHEDULER_NAME}")
    base_lr = cfg.SOLVER.BASE_LR
    warmup_iters = cfg.SOLVER.WARMUP_ITERS
    warmup_factor = cfg.SOLVER.WARMUP_FACTOR
    steps = sorted(cfg.SOLVER.STEPS)
    gamma = cfg.SOLVER.GAMMA

    def schedule(step):
        warm = warmup_factor + (1 - warmup_factor) * min(step / max(warmup_iters, 1), 1.0)
        decays = sum(step >= s for s in steps)
        return base_lr * (warm if step < warmup_iters else 1.0) * gamma ** decays

    return schedule


def build_optimizer(cfg, model: nn.Module) -> torch.optim.AdamW:
    """AdamW over the trainable parameters in two groups, ``backbone`` (at
    BACKBONE_MULTIPLIER) and ``main``; frozen parameters are in neither."""
    if cfg.SOLVER.OPTIMIZER.upper() != "ADAMW":
        raise NotImplementedError(f"the port has the AdamW recipe only, got {cfg.SOLVER.OPTIMIZER}")
    lr = cfg.SOLVER.BASE_LR
    groups = {"backbone": [], "main": []}
    for name, p in model.named_parameters():
        if not is_frozen(name):
            groups["backbone" if is_backbone(name) else "main"].append(p)
    return torch.optim.AdamW(
        [{"params": groups["backbone"], "lr": lr * cfg.SOLVER.BACKBONE_MULTIPLIER, "name": "backbone"},
         {"params": groups["main"], "lr": lr, "name": "main"}],
        lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=cfg.SOLVER.WEIGHT_DECAY,
    )


def build_lr_scheduler(cfg, optimizer: torch.optim.Optimizer) -> torch.optim.lr_scheduler.LambdaLR:
    """Scales each group's rate by schedule(step) / BASE_LR; step 0 at construction."""
    schedule = build_lr_schedule(cfg)
    base_lr = cfg.SOLVER.BASE_LR
    return torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: schedule(step) / base_lr)


@dataclass
class GradClip:
    """Clip by the global L2 norm over every gradient, as optax's
    ``clip_by_global_norm``: g * max_norm / max(norm, max_norm)."""

    max_norm: float

    def __call__(self, params: Iterable[nn.Parameter]) -> torch.Tensor:
        """Clips in place; returns the global gradient norm before clipping."""
        grads = [p.grad for p in params if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        scale = self.max_norm / torch.clamp(norm, min=self.max_norm)
        for g in grads:
            g.mul_(scale.to(g.dtype))
        return norm


def build_grad_clip(cfg) -> Optional[GradClip]:
    c = cfg.SOLVER.CLIP_GRADIENTS
    if not c.ENABLED:
        return None
    if c.CLIP_TYPE not in ("full_model", "norm"):
        raise NotImplementedError(f"the port clips by the global norm only, got {c.CLIP_TYPE}")
    return GradClip(c.CLIP_VALUE)
