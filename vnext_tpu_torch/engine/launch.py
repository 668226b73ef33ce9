"""Launch of the entry point: one process per card, over a ``torch.distributed`` group.

Counterpart of ``vnext_tpu.engine.launch.launch`` (reference surface:
detectron2/engine/launch.py:27). The world is ``num_machines x
num_gpus_per_machine`` processes. A world of 1 calls ``main_func(*args)``
straight through, with no group. Otherwise each machine runs one process per
local card (``torch.multiprocessing.spawn`` with the spawn start method where
there is more than one; the calling process itself where there is one), of
global rank ``machine_rank * num_gpus_per_machine + local``, which sets its
card and joins an NCCL group at ``dist_url`` ("auto": a free port on this
machine, for one machine only). ``device="cpu"`` makes the processes join a
gloo group and touch no card, as the tests do; a card asked for and absent
raises, as the entry points do. ``main_func`` and ``args`` must pickle where
processes are spawned.
"""

from __future__ import annotations

import logging
import os
import socket
from datetime import timedelta
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger("vnext_tpu_torch")

TIMEOUT = timedelta(minutes=30)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(
    main_func: Callable,
    num_gpus_per_machine: int = 0,
    num_machines: int = 1,
    machine_rank: int = 0,
    dist_url: Optional[str] = None,
    args: Sequence[Any] = (),
    device: str = "cuda",
) -> Any:
    """Run ``main_func(*args)`` in every process of the world (its result is
    returned where it ran in this process, else None). ``num_gpus_per_machine``
    0 counts as 1."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"launch: device {device!r} is 'cuda' or 'cpu'")
    n_local = max(num_gpus_per_machine, 1)
    world = num_machines * n_local
    if world == 1:
        return main_func(*args)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"launch: {n_local} card(s) asked for on this machine and no CUDA device is visible; "
                               "the launch does not fall back to the CPU")
        if torch.cuda.device_count() < n_local:
            raise RuntimeError(f"launch: {n_local} cards asked for on this machine, "
                               f"{torch.cuda.device_count()} visible")
    if not dist_url or dist_url == "auto":
        if num_machines > 1:
            raise ValueError("launch: more than one machine needs a --dist-url every machine can reach")
        dist_url = f"tcp://127.0.0.1:{free_port()}"
    worker_args = (main_func, world, n_local, machine_rank, dist_url, tuple(args), device)
    if n_local == 1:
        return _distributed_worker(0, *worker_args)
    torch.multiprocessing.start_processes(_distributed_worker, args=worker_args, nprocs=n_local,
                                          start_method="spawn")
    return None


def _distributed_worker(local_rank: int, main_func: Callable, world: int, n_local: int, machine_rank: int,
                        dist_url: str, args: tuple, device: str) -> Any:
    rank = machine_rank * n_local + local_rank
    os.environ["LOCAL_RANK"] = str(local_rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(n_local)
    if device == "cuda":
        torch.cuda.set_device(local_rank)
    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=dist_url, world_size=world, rank=rank, timeout=TIMEOUT)
    logger.info("process group (%s) joined: rank %d of %d, local %d of %d", backend, rank, world, local_rank,
                n_local)
    try:
        return main_func(*args)
    finally:
        dist.destroy_process_group()
