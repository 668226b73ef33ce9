"""Process groups, device meshes and the data-parallel helpers.

Counterpart of ``vnext_tpu.parallel.mesh``. The JAX package runs one
controller over a ``jax.sharding.Mesh`` and lets XLA insert the collectives;
the port runs one process per card (``engine/launch.py``) over a
``torch.distributed`` process group (NCCL on the card, gloo where the caller
asked for the CPU), as detectron2's ``comm`` does:

- ``process_index`` / ``process_count`` / ``is_main_process`` /
  ``local_device_count`` read the group; with no group this process is rank 0
  of 1 with one local device.
- ``process_allgather`` gathers host objects through a gloo group made once
  beside the default group (the default one itself when it is gloo); with no
  group it is ``[x]``.
- ``build_mesh`` is a ``DeviceMesh`` with the JAX package's ``-1`` inference
  and axis names; ``batch_sharding`` / ``replicated`` are its placements,
  ``shard_batch`` this rank's slice of the leading dimension and ``replicate``
  a broadcast from rank 0.
- ``global_count`` turns a loss normalizer counted over this rank's batch into
  this rank's share of the count over the global batch, which is what makes
  DDP's averaged gradient the whole batch's: the JAX package writes every loss
  as a reduction over the global batch, where XLA adds the sum across devices.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

# the gloo group of each default group, made on first use by every rank at once
_GLOO_GROUPS: Dict[Any, Any] = {}


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """Rank of this process (detectron2's ``comm.get_rank``); 0 with no group."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """World size; 1 with no group."""
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def local_device_count() -> int:
    """The processes (one per card) on this machine: ``LOCAL_WORLD_SIZE`` as
    ``launch`` sets it; 1 with no group."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1)) if is_initialized() else 1


def _gloo_group():
    world = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return world
    if world not in _GLOO_GROUPS:
        _GLOO_GROUPS[world] = dist.new_group(backend="gloo")
    return _GLOO_GROUPS[world]


def process_allgather(obj: Any) -> List[Any]:
    """Every rank's ``obj`` (picklable host data), in rank order; ``[obj]``
    with no group. Every rank must call it (a group of one too: the gather
    runs, as on more ranks)."""
    if not is_initialized():
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj, group=_gloo_group())
    return out


def global_count(count: torch.Tensor, min_value: float = 1.0) -> torch.Tensor:
    """A loss normalizer: ``count`` (f32) clamped at ``min_value`` with no
    group; with one (of one rank too), the count summed over the ranks,
    clamped, divided by the world size. A rank's loss ``local_sum / global_count(n)`` is then
    ``local_sum * world / N``, so the mean of the ranks' gradients (DDP's) is
    the gradient of ``sum / N`` over the global batch. Every rank must call it
    in the same order. The count carries no gradient."""
    count = count.detach().float()
    if not is_initialized():
        return count.clamp_min(min_value)
    total = count.clone()
    dist.all_reduce(total)
    return total.clamp_min(min_value) / process_count()


def mean_over_ranks(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scalar metrics averaged over the ranks, in one all-reduce; as they are with no group."""
    if not is_initialized() or not values:
        return values
    keys = sorted(values)
    stacked = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(stacked)
    stacked /= process_count()
    return dict(zip(keys, stacked.unbind()))


def _default_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def build_mesh(mesh_shape: Sequence[int] = (-1,), axis_names: Sequence[str] = ("data",),
               device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the world (one card, or one CPU process, a rank);
    a -1 in ``mesh_shape`` takes what the other axes leave. Needs the process
    group that ``launch`` makes."""
    from torch.distributed.device_mesh import init_device_mesh

    if not is_initialized():
        raise RuntimeError("build_mesh needs a process group: start the program through engine.launch.launch")
    shape = list(mesh_shape)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1) or 1
        shape[shape.index(-1)] = process_count() // known
    return init_device_mesh(device_type or _default_device_type(), tuple(shape), mesh_dim_names=tuple(axis_names))


def _axis_dim(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (its axes: {names})")
    return names.index(axis)


def batch_sharding(mesh, axis: str = "data") -> list:
    """The placements of a batch split over ``axis``: ``Shard(0)`` on it, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    d = _axis_dim(mesh, axis)
    return [Shard(0) if i == d else Replicate() for i in range(mesh.ndim)]


def replicated(mesh) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim


def axis_slice(n: int, mesh, axis: str = "data") -> slice:
    """This rank's part of ``n`` rows split evenly over ``axis`` (``n`` must divide)."""
    d = _axis_dim(mesh, axis)
    size = mesh.size(d)
    if n % size:
        raise ValueError(f"{n} rows do not split evenly over the {size} ranks of axis {axis!r}")
    rank = mesh.get_local_rank(d)
    return slice(rank * (n // size), (rank + 1) * (n // size))


def shard_batch(tree: Any, mesh, axis: str = "data") -> Any:
    """This rank's slice of the leading dimension of every tensor or array
    leaf of ``tree`` (dicts, lists, tuples and named tuples); the leading
    dimensions must divide by the axis' size."""
    def cut(x):
        if isinstance(x, torch.Tensor) or hasattr(x, "shape"):
            return x[axis_slice(x.shape[0], mesh, axis)]
        return x

    return pytree.tree_map(cut, tree)


def replicate(tree: Any, mesh=None) -> Any:
    """Every tensor leaf of ``tree`` as rank 0 holds it (a broadcast over the
    default group); the tree as it is with no group."""
    if not is_initialized() or process_count() == 1:
        return tree

    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        y = x.detach().clone()
        dist.broadcast(y, src=0)
        return y

    return pytree.tree_map(bcast, tree)
