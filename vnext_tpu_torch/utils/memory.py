"""OOM fallback helper (reference surface: detectron2/utils/memory.py:26
retry_if_cuda_oom), the port's copy of ``vnext_tpu.utils.memory``: a batched
call that runs out of device memory is retried on halved leading-dim shards,
whose results are concatenated."""

from __future__ import annotations

import functools
import logging
from typing import Callable

import numpy as np
import torch

logger = logging.getLogger("vnext_tpu_torch")


def _is_oom(e: Exception) -> bool:
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    msg = str(e).lower()
    return "resource exhausted" in msg or "out of memory" in msg or "oom" in msg


def _concat(chunks):
    if all(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat(chunks, 0)
    return np.concatenate([np.asarray(c) for c in chunks], axis=0)


def retry_if_oom(fn: Callable, max_splits: int = 3) -> Callable:
    """Wrap a batched fn(x, ...) so device OOM retries on halved leading-dim
    shards (2, 4, ... 2**max_splits of them, never more than x has rows).
    Tensor results are concatenated as tensors, others as numpy arrays."""

    @functools.wraps(fn)
    def wrapped(x, *args, **kwargs):
        try:
            return fn(x, *args, **kwargs)
        except RuntimeError as e:   # torch.cuda.OutOfMemoryError is a RuntimeError
            if not _is_oom(e):
                raise
        for split in range(1, max_splits + 1):
            parts = 2**split
            n = x.shape[0]
            if parts > n:
                break
            logger.warning("OOM: retrying %s in %d shards", getattr(fn, "__name__", "fn"), parts)
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            try:
                step = (n + parts - 1) // parts
                return _concat([fn(x[i : i + step], *args, **kwargs) for i in range(0, n, step)])
            except RuntimeError as e:
                if not _is_oom(e):
                    raise
        raise RuntimeError("retry_if_oom: still OOM after max splits")

    return wrapped
