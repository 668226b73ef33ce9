"""Distribution: process groups, device meshes, global loss counts, tensor and time parallelism.

Counterpart of ``vnext_tpu.parallel``, over ``torch.distributed``; the
processes are started by ``vnext_tpu_torch.engine.launch.launch``.
"""

from .mesh import (
    batch_sharding,
    build_mesh,
    global_count,
    is_main_process,
    local_device_count,
    mean_over_ranks,
    process_allgather,
    process_count,
    process_index,
    replicate,
    replicated,
    shard_batch,
)
from .tensor_parallel import (
    apply_tp,
    infer_tp_specs,
    make_sharded_clip_inference,
    shard_clip,
    time_sharding,
)

__all__ = [
    "batch_sharding",
    "build_mesh",
    "global_count",
    "is_main_process",
    "local_device_count",
    "mean_over_ranks",
    "process_allgather",
    "process_count",
    "process_index",
    "replicate",
    "replicated",
    "shard_batch",
    "apply_tp",
    "infer_tp_specs",
    "make_sharded_clip_inference",
    "shard_clip",
    "time_sharding",
]
