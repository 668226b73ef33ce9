"""Data loaders: the infinite clip train loader and the one-pass test loader.

Counterpart of the parts of ``vnext_tpu.data.build`` IDOL's entry point runs:
a shuffled infinite sampler feeds the mapper, mapped clips are stacked into
fixed-shape numpy batches, and a background thread keeps a small queue of
batches full while the previous step runs on the card. The batches stay numpy:
the thread never touches CUDA.

One divergence from the JAX package, kept on purpose: an exception raised in
the prefetch thread (a mapper fault, an unreadable image) is raised again at
the consumer's next ``next()``, where the JAX package's iterator ends the loader
with ``StopIteration`` and the error reaches only stderr.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from .catalog import DatasetCatalog
from .dataset_mapper import YTVISDatasetMapper


class TrainingSampler:
    """Infinite stream of dataset indices, shuffled per epoch with a seed. One
    process reads every index: the JAX package's sharding across processes
    comes with the port's distribution (ROADMAP Queue 1, item 12)."""

    def __init__(self, size: int, seed: int = 0):
        if size <= 0:
            raise ValueError(f"TrainingSampler needs a non-empty dataset, got size {size}")
        self._size = size
        self._seed = seed

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self._seed)
        while True:
            yield from g.permutation(self._size).tolist()


class InferenceSampler:
    """One pass over the dataset, in order."""

    def __init__(self, size: int):
        self._indices = list(range(size))

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


def _stack_clip_batch(samples: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Collate mapper outputs into batched fixed-shape arrays."""
    def stack(path_fn):
        return np.stack([path_fn(s) for s in samples])

    out = {}
    for frame in ("key", "ref"):
        out[f"{frame}_image"] = stack(lambda s: s[frame]["image"])
        out[f"{frame}_size"] = stack(lambda s: s[frame]["size"])
        for field in ("labels", "boxes", "masks_s4", "valid", "inst_id"):
            out[f"{frame}_{field}"] = stack(lambda s: s[frame][field])
    return out


class PrefetchIterator:
    """Wrap an iterator with a daemon-thread prefetch queue of two items (double
    buffering the host pipeline against the card). An exception in the thread
    is raised at the consumer's next ``next()``, and at every one after it."""

    def __init__(self, it: Iterator):
        self._it = it
        self._queue: queue.Queue = queue.Queue(maxsize=2)
        self._done = object()
        self._error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._queue.put(item)
        except Exception as e:  # handed to the consumer, who raises it
            self._error = e
        finally:
            self._queue.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._done:
            self._queue.put(self._done)  # later calls end the same way
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def build_vis_train_loader(
    cfg=None,
    mapper: Optional[YTVISDatasetMapper] = None,
    dataset_dicts: Optional[List[dict]] = None,
    batch_size: Optional[int] = None,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite batched train loader of clip samples. Every loader of one seed
    gives the same batches from its start (a resumed run starts it again)."""
    if dataset_dicts is None:
        dataset_dicts = [d for n in cfg.DATASETS.TRAIN for d in DatasetCatalog.get(n)]
    if mapper is None:
        mapper = YTVISDatasetMapper.from_config(cfg, is_train=True)
    if batch_size is None:
        batch_size = cfg.SOLVER.IMS_PER_BATCH
    sampler = TrainingSampler(len(dataset_dicts), seed=seed)

    def gen():
        rng = random.Random(seed * 1000)  # the JAX package's draw for shard 0
        batch = []
        for idx in sampler:
            batch.append(mapper(dataset_dicts[idx], rng))
            if len(batch) == batch_size:
                yield _stack_clip_batch(batch)
                batch = []

    return PrefetchIterator(gen())


def build_vis_test_loader(
    cfg=None,
    dataset_name: Optional[str] = None,
    dataset_dicts: Optional[List[dict]] = None,
):
    """One video record at a time (a batch of one video)."""
    if dataset_dicts is None:
        dataset_dicts = DatasetCatalog.get(dataset_name or cfg.DATASETS.TEST[0])
    for idx in InferenceSampler(len(dataset_dicts)):
        yield dataset_dicts[idx]
