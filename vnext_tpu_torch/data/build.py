"""Data loaders: the infinite clip train loader, the one-pass test loader and
the samplers and grouping under them.

Counterpart of ``vnext_tpu.data.build``: a shuffled infinite sampler feeds the
mapper, mapped clips are stacked into fixed-shape numpy batches, and a
background thread keeps a small queue of batches full while the previous step
runs on the card. The batches stay numpy: the thread never touches CUDA.
``RepeatFactorTrainingSampler`` (category-frequency rebalancing) and
``AspectRatioGroupedDataset`` (orientation buckets) are here for callers that
build their own loader; the clip loader, as the JAX package's, uses neither
(it reads no ``DATALOADER.SAMPLER_TRAIN``).

One divergence from the JAX package, kept on purpose: an exception raised in
the prefetch thread (a mapper fault, an unreadable image) is raised again at
the consumer's next ``next()``, where the JAX package's iterator ends the loader
with ``StopIteration`` and the error reaches only stderr.
"""

from __future__ import annotations

import queue
import random
import threading
from collections import Counter
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from .catalog import DatasetCatalog
from .dataset_mapper import YTVISDatasetMapper


class TrainingSampler:
    """Infinite stream of dataset indices, shuffled per epoch with a seed. One
    process reads every index: the JAX package's sharding across processes
    comes with the port's distribution (ROADMAP Queue 1, item 12). The JAX
    package's ``shuffle=False`` (in order, epoch after epoch) is left out: no
    caller of either package sets it."""

    def __init__(self, size: int, seed: int = 0):
        if size <= 0:
            raise ValueError(f"TrainingSampler needs a non-empty dataset, got size {size}")
        self._size = size
        self._seed = seed

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self._seed)
        while True:
            yield from g.permutation(self._size).tolist()


def _categories(record: dict) -> set:
    """The category ids of an image record, or of every frame of a video record."""
    annos = record.get("annotations") or []
    if annos and isinstance(annos[0], list):
        return {o["category_id"] for frame in annos for o in frame}
    return {o["category_id"] for o in annos}


class RepeatFactorTrainingSampler:
    """Category-frequency rebalancing (detectron2's sampler for LVIS): record I
    repeats r(I) = max over its categories c of max(1, sqrt(t / f(c))) times an
    epoch, f(c) the share of records holding c, the fractional part drawn
    anew each epoch; each epoch's indices are shuffled. Image and video records
    (a list of annotations per frame) both count."""

    def __init__(self, dataset_dicts: List[dict], repeat_thresh: float, seed: int = 0):
        cats = [_categories(rec) for rec in dataset_dicts]
        counts = Counter(c for rec_cats in cats for c in rec_cats)
        freqs = {c: counts[c] / len(dataset_dicts) for c in counts}
        self._repeat_factors = np.asarray(
            [max([1.0] + [max(1.0, np.sqrt(repeat_thresh / freqs[c])) for c in rec_cats]) for rec_cats in cats])
        self._seed = seed

    def __iter__(self) -> Iterator[int]:
        g = np.random.RandomState(self._seed)
        int_part = np.floor(self._repeat_factors).astype(np.int64)
        frac = self._repeat_factors - int_part
        while True:
            rounds = int_part + (g.rand(len(frac)) < frac)
            indices = np.repeat(np.arange(len(rounds)), rounds)
            yield from indices[g.permutation(len(indices))].tolist()


class InferenceSampler:
    """One pass over the dataset, in order."""

    def __init__(self, size: int):
        self._indices = list(range(size))

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class AspectRatioGroupedDataset:
    """Batches of ``batch_size`` samples of one orientation (detectron2's
    two-bucket grouping: landscape and portrait), so that a batch pads little.
    Wraps an iterable of samples carrying ``height`` / ``width`` (or a
    ``key_fn`` giving the bucket, 0 or 1); a sample waits in its bucket until
    the bucket is full."""

    def __init__(self, it: Iterable, batch_size: int, key_fn: Optional[Callable[[Any], int]] = None):
        self._it = it
        self._batch_size = batch_size
        self._key_fn = key_fn or (lambda s: int(s["width"] > s["height"]))

    def __iter__(self) -> Iterator[List]:
        buckets: List[List] = [[], []]
        for sample in self._it:
            bucket = buckets[self._key_fn(sample)]
            bucket.append(sample)
            if len(bucket) == self._batch_size:
                yield bucket[:]
                bucket.clear()


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
    mapper: Optional[Callable[[dict, random.Random], Dict[str, Any]]] = None,
    dataset_dicts: Optional[List[dict]] = None,
    batch_size: Optional[int] = None,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite batched train loader of clip samples: ``mapper`` (default: the
    YTVIS mapper from ``cfg``; the COCO-pretrain stage passes a
    ``CocoClipDatasetMapper``) maps ``(record, rng)`` to a clip. Every loader of
    one seed gives the same batches from its start (a resumed run starts it
    again)."""
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
