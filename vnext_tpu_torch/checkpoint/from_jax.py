"""Weight bridge from the JAX package's flax parameter tree to the port.

The port's module and parameter names follow the flax tree, so the mapping is
mechanical: the dotted flax path is the state-dict key, with

- a 2-d ``kernel`` [in, out] (Dense)       -> ``weight`` [out, in]
- a 4-d ``kernel`` HWIO (Conv)             -> ``weight`` OIHW
- a 5-d ``kernel`` DHWIO (3-D Conv)        -> ``weight`` OIDHW
- ``scale`` (LayerNorm / GroupNorm)        -> ``weight``
- everything else (biases, FrozenBN statistics, embeddings, InstMove's
  ``memory_w``) as it is.

The map goes by path and rank alone, so a ``ConvTranspose`` kernel (flax's
(kh, kw, in, out), ``transpose_kernel=False``) takes the 4-d rule too: the
port's ``ConvTranspose`` keeps that layout in its parameter and arranges it for
``conv_transpose2d`` at use (``models/layers.py``; InstMove's decoder, the
Mask R-CNN mask head and the keypoint head's 4x4 ``score_lowres`` use it).
A rank-1 leaf that is not a kernel, such as FCOS's per-level ``scales``,
carries across as it is, and the cascade's ``stage{k}`` heads by their paths;
so do PanopticFPN's and SemanticSegmentor's ``sem_seg_head`` (its
``head_p{2..5}_conv`` kernels by the 4-d rule, its ``head_p{2..5}_norm``
GroupNorm scales by ``scale``, its 1x1 ``predictor``). The trees of the
ResNet variants and the other heads need no rule of their own: a ResNeXt's
grouped 3x3 kernel [3, 3, in / groups, out] becomes [out, in / groups, 3, 3]
by the 4-d rule, which is ``conv2d``'s grouped layout; a DCN block's
``conv2_offset`` is a convolution like any other, and its raw 3x3 weight
``conv2_weight`` (not named ``kernel``) carries across as it is, HWIO, the
layout the port's ``Bottleneck`` keeps it in; RegNet's squeeze-excitation
``fc1`` / ``fc2`` are 1x1 convolutions; the C4 head's ``mask_deconv`` is a
``ConvTranspose``; the rotated heads' ``fc1``, ``fc2``, ``cls_score`` and
``bbox_pred`` are Dense layers. ``ASPP``'s convolutions take the 4-d rule;
``SyncBatchNorm``'s flax ``bn`` scale and bias carry across as any norm's,
and its ``batch_stats`` (``mean``, ``var``), merged into the same tree under
``bn``, as they are, into the module's buffers.

The input is a nested dict of numpy arrays (``jax.tree.map(np.asarray, params)``),
so this module needs neither jax nor flax.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key + "."))
        else:
            flat[key] = np.asarray(v)
    return flat


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested flax params (numpy leaves) -> the port's state dict (f32 tensors)."""
    out = {}
    for path, arr in _flatten(tree).items():
        head, _, leaf = path.rpartition(".")
        prefix = f"{head}." if head else ""
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 5:
                arr = arr.transpose(4, 3, 0, 1, 2)
            else:
                raise ValueError(f"{path}: a kernel of rank {arr.ndim}")
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[prefix + leaf] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
    return out


def load_from_jax(model: nn.Module, tree: Mapping) -> None:
    """Load bridged flax params into ``model``; raises on any key left over in
    either direction and on any shape that differs."""
    state = params_from_jax(tree)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"weight bridge: missing in the flax tree {missing}, "
                       f"not in the port {unexpected}")
    bad = [k for k in own if tuple(own[k].shape) != tuple(state[k].shape)]
    if bad:
        raise ValueError("weight bridge: shapes differ for " + ", ".join(
            f"{k} {tuple(own[k].shape)} vs {tuple(state[k].shape)}" for k in bad))
    model.load_state_dict(state, strict=True)
