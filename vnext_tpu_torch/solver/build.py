"""Optimizer, learning-rate schedule and gradient clipping.

Counterpart of ``vnext_tpu.solver.build``: AdamW (the IDOL recipe) or SGD
with momentum and Nesterov (the Detectron2 recipe), each with the backbone at
``BACKBONE_MULTIPLIER``; WarmupMultiStepLR or WarmupCosineLR; clipping by the
global gradient norm over the whole model (``full_model``, which every IDOL
config in ``configs/`` sets) or by value. The JAX package masks parameter
trees with optax; here the same path substrings sort the port's parameter
names (which follow the flax tree) into groups.

Points of parity with the JAX package:

- optax counts updates from 0, so the first update uses the schedule's step 0;
  ``LambdaLR`` sets that rate at construction and advances it after each step.
- The JAX chain clips by the global norm *before* it zeroes the frozen
  parameters' updates, so that norm counts the gradients of the frozen
  parameters too (FrozenBN weights, biases and statistics, the stem, layer1).
  Every parameter here requires a gradient, the clip runs over all of them, and
  the frozen ones are in no parameter group, so the optimizer never moves them.
  Clipping by value (optax's ``clip``) clamps every gradient the same way.
- ``optax.sgd`` takes no weight decay: SGD ignores ``WEIGHT_DECAY`` (the
  Detectron2 yamls' 1e-4), so ``torch.optim.SGD`` runs with none. Its
  momentum buffer (``g`` at the first step, ``m * buf + g`` after, Nesterov
  ``g + m * buf``) is optax's ``trace``.
- WarmupCosineLR is JAX's formula: the linear warm-up alone before
  ``WARMUP_ITERS``, the half cosine over ``MAX_ITER`` alone from there (not
  detectron2's product of the two).
"""

from __future__ import annotations

import math
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
    """step -> learning rate: linear warmup, then multi-step decay
    (WarmupMultiStepLR) or a half cosine (WarmupCosineLR)."""
    name = cfg.SOLVER.LR_SCHEDULER_NAME
    if name not in ("WarmupMultiStepLR", "WarmupCosineLR"):
        raise NotImplementedError(f"LR_SCHEDULER_NAME {name!r}: the port has WarmupMultiStepLR and WarmupCosineLR")
    base_lr = cfg.SOLVER.BASE_LR
    warmup_iters = cfg.SOLVER.WARMUP_ITERS
    warmup_factor = cfg.SOLVER.WARMUP_FACTOR
    max_iter = cfg.SOLVER.MAX_ITER
    steps = sorted(cfg.SOLVER.STEPS)
    gamma = cfg.SOLVER.GAMMA

    def schedule(step):
        warm = warmup_factor + (1 - warmup_factor) * min(step / max(warmup_iters, 1), 1.0)
        if name == "WarmupCosineLR":
            progress = min(max(step / max(max_iter, 1), 0.0), 1.0)
            return base_lr * (warm if step < warmup_iters else 0.5 * (1.0 + math.cos(math.pi * progress)))
        decays = sum(step >= s for s in steps)
        return base_lr * (warm if step < warmup_iters else 1.0) * gamma ** decays

    return schedule


def build_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """AdamW or SGD (``SOLVER.OPTIMIZER``) over the trainable parameters in two
    groups, ``backbone`` (at BACKBONE_MULTIPLIER) and ``main``; frozen
    parameters are in neither."""
    lr = cfg.SOLVER.BASE_LR
    groups = {"backbone": [], "main": []}
    for name, p in model.named_parameters():
        if not is_frozen(name):
            groups["backbone" if is_backbone(name) else "main"].append(p)
    params = [{"params": groups["backbone"], "lr": lr * cfg.SOLVER.BACKBONE_MULTIPLIER, "name": "backbone"},
              {"params": groups["main"], "lr": lr, "name": "main"}]
    if cfg.SOLVER.OPTIMIZER.upper() == "ADAMW":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.SOLVER.WEIGHT_DECAY)
    # optax.sgd: no weight decay; momentum 0 is plain SGD in both
    return torch.optim.SGD(params, lr=lr, momentum=cfg.SOLVER.MOMENTUM, nesterov=cfg.SOLVER.NESTEROV,
                           weight_decay=0.0)


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


@dataclass
class ValueClip:
    """Clip every gradient element into [-clip_value, clip_value], as optax's
    ``clip``."""

    clip_value: float

    def __call__(self, params: Iterable[nn.Parameter]) -> None:
        """Clips in place; returns nothing (no norm is taken)."""
        for p in params:
            if p.grad is not None:
                p.grad.clamp_(-self.clip_value, self.clip_value)


def build_grad_clip(cfg) -> Optional[Callable]:
    """``GradClip`` for ``CLIP_TYPE`` "full_model" or "norm", else
    ``ValueClip`` (JAX's ``optax.clip`` for any other type); None when
    clipping is off."""
    c = cfg.SOLVER.CLIP_GRADIENTS
    if not c.ENABLED:
        return None
    if c.CLIP_TYPE in ("full_model", "norm"):
        return GradClip(c.CLIP_VALUE)
    return ValueClip(c.CLIP_VALUE)
