"""Tensor parallelism by rule, and clip inference with the frames split over ranks.

Counterpart of ``vnext_tpu.parallel.tensor_parallel``:

- ``infer_tp_specs`` applies the JAX package's rule to the port's parameters:
  a parameter whose flax leaf has a last axis of at least ``min_features``
  that divides by the ``axis``' size is split along that axis. A flax kernel's
  last axis is its output one, which is dim 0 of the port's ``Dense`` weight
  [out, in] and ``Conv`` weight OIHW (``checkpoint/from_jax.py``); any other
  leaf keeps its last axis. So the selection is JAX's, by the bridge's names.
- ``apply_tp`` splits the selected ``Dense`` and ``Conv`` layers column-wise:
  their weight and bias become ``DTensor`` shards (``Shard(0)``) over the
  axis, each rank computes its output channels with its local shard, and the
  output is gathered back to a replicated plain tensor, so every module after
  it, the hand-written kernels included, receives plain tensors. The other
  selected parameters (norm scales and statistics, embeddings), the layers
  whose weights a kernel reads directly (the ResNet stem's, K2; the encoder
  FFN's, K3) and grouped or transposed convolutions stay replicated, where
  XLA splits them too; the step's numbers are the same either way.
  torch's own ``ColwiseParallel`` takes ``nn.Linear`` and ``nn.Embedding``
  only, and DTensor's convolution rule does not split output channels, hence
  this style of the same design.
- ``time_sharding`` / ``shard_clip`` / ``make_sharded_clip_inference``: each
  rank runs ``IDOL.inference`` on its T / world frames (IDOL treats frames as
  batch entries) and the outputs are all-gathered along T; T must divide by
  the axis' size, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import _axis_dim, axis_slice, batch_sharding


def _flax_last_dim(module: nn.Module, name: str, param: torch.Tensor) -> int:
    """The port's dim of the flax leaf's last axis."""
    from ..utils.analysis import _flax_leaf

    return 0 if _flax_leaf(module, name, param) == "kernel" else param.dim() - 1


def infer_tp_specs(model: nn.Module, mesh, axis: str = "model", min_features: int = 256) -> Dict[str, object]:
    """{parameter name: ``Shard(d)`` or ``Replicate()``}: ``Shard`` along the
    flax leaf's last axis where that axis is >= ``min_features`` and divides by
    the size of ``axis``, as the JAX package's rule selects."""
    from torch.distributed.tensor import Replicate, Shard

    n = mesh.size(_axis_dim(mesh, axis))
    specs = {}
    for mod_name, module in model.named_modules():
        for name, p in module.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            if p.dim() == 0:
                specs[full] = Replicate()
                continue
            d = _flax_last_dim(module, name, p)
            specs[full] = Shard(d) if p.shape[d] >= min_features and p.shape[d] % n == 0 else Replicate()
    return specs


def _kernel_read_modules(model: nn.Module) -> set:
    """Layers whose weights a hand-written kernel reads outside their own
    forward: the ResNet stem's convolution (K2) and the encoder layers' FFN (K3)."""
    from ..models.backbones.resnet import ResNet
    from ..models.deformable_transformer import EncoderLayer

    out = set()
    for m in model.modules():
        if isinstance(m, ResNet):
            out.add(m.conv1)
        elif isinstance(m, EncoderLayer):
            out.update((m.linear1, m.linear2))
    return out


def _colwise(module: nn.Module, mesh, out_dim: int) -> None:
    """Split ``module``'s weight and bias on dim 0 over the 1-d ``mesh``; its
    forward runs on the local shards and gathers the output along ``out_dim``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    for name in ("weight", "bias"):
        p = getattr(module, name)
        if p is not None:
            setattr(module, name, nn.Parameter(distribute_tensor(p.detach(), mesh, [Shard(0)])))
    own_forward = type(module).forward

    def forward(*args, **kwargs):
        saved = dict(module._parameters)
        try:
            for name, p in saved.items():
                if isinstance(p, DTensor):
                    module._parameters[name] = p.to_local()
            y = own_forward(module, *args, **kwargs)
        finally:
            module._parameters.update(saved)
        local = DTensor.from_local(y, mesh, [Shard(out_dim % y.dim())], run_check=False)
        return local.redistribute(mesh, [Replicate()]).to_local()

    module.forward = forward


def apply_tp(model: nn.Module, mesh, axis: str = "model", min_features: int = 256) -> nn.Module:
    """Split ``model``'s selected ``Dense`` and ``Conv`` layers column-wise over
    ``axis`` of ``mesh`` (in place; returns the model). Every rank holds the
    same weights before the call."""
    from torch.distributed.tensor import Shard

    from ..models.layers import Conv, ConvTranspose, Dense

    specs = infer_tp_specs(model, mesh, axis, min_features)
    sub = mesh[axis] if mesh.ndim > 1 else mesh
    skip = _kernel_read_modules(model)
    for mod_name, module in model.named_modules():
        if (module in skip or not isinstance(module, (Dense, Conv)) or isinstance(module, ConvTranspose)
                or getattr(module, "groups", 1) != 1):
            continue
        prefix = f"{mod_name}." if mod_name else ""
        if specs.get(prefix + "weight") != Shard(0):
            continue
        _colwise(module, sub, -1 if isinstance(module, Dense) else 1)
    return model


def time_sharding(mesh, axis: str = "data") -> list:
    """The placements of [T, ...] clip tensors with the frames split over ``axis``."""
    return batch_sharding(mesh, axis)


def shard_clip(frames: torch.Tensor, sizes: torch.Tensor, mesh, axis: str = "data"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's frames [T / n, H, W, 3] and sizes [T / n, 2] of a clip; T
    must be a multiple of the axis' size n (the caller pads the clip)."""
    part = axis_slice(frames.shape[0], mesh, axis)
    return frames[part], sizes[part]


def make_sharded_clip_inference(model: nn.Module, mesh, axis: str = "data") -> Callable:
    """``fn(frames, sizes)`` -> ``IDOL.inference``'s outputs over the whole
    clip [T, ...]: each rank serves its frames (``shard_clip``) and the
    outputs are all-gathered along T over ``axis``. ``model`` (in eval mode)
    holds the same weights on every rank; the JAX package's ``fn`` takes them
    as its first argument."""
    group = mesh.get_group(_axis_dim(mesh, axis))
    n = mesh.size(_axis_dim(mesh, axis))

    @torch.no_grad()
    def fn(frames: torch.Tensor, sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        local = model.inference(*shard_clip(frames, sizes, mesh, axis))
        out = {}
        for k, v in local.items():
            v = v.contiguous()
            parts = [torch.empty_like(v) for _ in range(n)]
            dist.all_gather(parts, v, group=group)
            out[k] = torch.cat(parts)
        return out

    return fn
