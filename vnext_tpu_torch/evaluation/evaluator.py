"""The evaluation loop and evaluator combiner.

Counterpart of ``vnext_tpu.evaluation.evaluator`` (detectron2's
``DatasetEvaluators`` and ``inference_on_dataset``): every batch goes through
the model and the evaluator, and the loop logs the time per batch after a
warm-up.
"""

from __future__ import annotations

import datetime
import logging
import time
from collections import OrderedDict
from typing import Callable, Iterable, List, Optional

from .ytvis_eval import DatasetEvaluator

logger = logging.getLogger("vnext_tpu_torch")


class DatasetEvaluators(DatasetEvaluator):
    """Run several evaluators over the same prediction stream."""

    def __init__(self, evaluators: List[DatasetEvaluator]):
        self._evaluators = evaluators

    def reset(self):
        for e in self._evaluators:
            e.reset()

    def process(self, inputs, outputs):
        for e in self._evaluators:
            e.process(inputs, outputs)

    def evaluate(self):
        results = OrderedDict()
        for e in self._evaluators:
            r = e.evaluate()
            if r is None:
                continue
            for k, v in r.items():
                if k in results:
                    raise ValueError(f"two evaluators return the key {k!r}")
                results[k] = v
        return results


def inference_on_dataset(
    model: Callable,
    data_loader: Iterable,
    evaluator: Optional[DatasetEvaluator],
    warmup_iters: int = 5,
):
    """Feed every batch through ``model`` and the evaluator and return the
    evaluator's results; logs the time per batch after ``warmup_iters``.
    ``model(inputs)`` returns the outputs the evaluator expects."""
    if evaluator is None:
        evaluator = DatasetEvaluators([])
    evaluator.reset()
    total_time = 0.0
    n_timed = 0
    total = 0
    start = time.perf_counter()
    for idx, inputs in enumerate(data_loader):
        t0 = time.perf_counter()
        outputs = model(inputs)
        t1 = time.perf_counter()
        if idx >= warmup_iters:
            total_time += t1 - t0
            n_timed += 1
        evaluator.process(inputs if isinstance(inputs, list) else [inputs],
                          outputs if isinstance(outputs, list) else [outputs])
        total += 1
    wall = time.perf_counter() - start
    if n_timed:
        logger.info(
            "Inference done %d batches. Pure compute: %s/batch (%.2f/s); wall %s",
            total,
            datetime.timedelta(seconds=total_time / n_timed),
            n_timed / max(total_time, 1e-9),
            datetime.timedelta(seconds=int(wall)),
        )
    return evaluator.evaluate()
