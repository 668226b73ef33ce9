"""Checks of a run's results for the quick-schedule configs.

Counterpart of ``vnext_tpu.evaluation.testing``: ``cfg.TEST.EXPECTED_RESULTS``
is a list of ``[task, metric, expected, tolerance]`` rows held against the
evaluation's results, and ``cfg.TEST.FINAL_LOSS_BOUND`` bounds the last
training loss.
"""

from __future__ import annotations

import logging
import pprint
from typing import Dict, Mapping

import numpy as np

logger = logging.getLogger("vnext_tpu_torch")


def verify_results(cfg, results: Mapping[str, Mapping[str, float]]) -> bool:
    expected_results = cfg.TEST.EXPECTED_RESULTS
    if not len(expected_results):
        return True
    ok = True
    for task, metric, expected, tolerance in expected_results:
        actual = (results.get(task) or {}).get(metric)
        if actual is None or not np.isfinite(actual):
            ok = False
            continue
        if abs(actual - expected) > tolerance:
            ok = False
    if not ok:
        logger.error("Result verification failed!")
        logger.error("Expected Results: %s", expected_results)
        logger.error("Actual Results: %s", pprint.pformat(results))
        raise AssertionError(
            f"Result verification failed: expected {expected_results}, got {results}"
        )
    logger.info("Results verified: %s", expected_results)
    return True


def verify_final_loss(cfg, trainer) -> bool:
    """Assert the final training total_loss is finite and <= cfg.TEST.FINAL_LOSS_BOUND.

    The quick-schedule analogue of the reference's inference_acc assertions: a
    deliberately corrupted model diverges and fails this bound (EXPECTED_RESULTS
    alone cannot catch that on untrained synthetic-data runs where AP is pinned 0).
    """
    bound = float(getattr(cfg.TEST, "FINAL_LOSS_BOUND", 0.0) or 0.0)
    if bound <= 0:
        return True
    storage = getattr(trainer, "storage", None)
    if storage is None or "total_loss" not in storage.histories():
        raise AssertionError("FINAL_LOSS_BOUND set but no total_loss was recorded")
    # smoothing-window median (the value CommonMetricPrinter logs): a single
    # raw iteration's loss on a 3-iter quick schedule can spike ~5x while the
    # run is healthy; a corrupted model diverges in the median just the same
    hist = storage.history("total_loss")
    final = hist.median(20)
    latest = hist.latest()
    # the raw last iteration must itself be finite: a median over a mostly-
    # healthy window would otherwise mask a trailing divergence/NaN
    if not np.isfinite(latest):
        raise AssertionError(f"Final raw total_loss is non-finite: {latest}")
    if not np.isfinite(final) or final > bound:
        raise AssertionError(
            f"Final total_loss {final} violates TEST.FINAL_LOSS_BOUND {bound}"
        )
    logger.info("Final loss verified: %.4f <= %.4f", final, bound)
    return True


def flatten_results_dict(results: Mapping) -> Dict[str, float]:
    """{'a': {'b': 1}} -> {'a/b': 1} (nested task/metric dicts to flat keys)."""
    flat = {}
    for k, v in results.items():
        if isinstance(v, Mapping):
            for fk, fv in flatten_results_dict(v).items():
                flat[f"{k}/{fk}"] = fv
        else:
            flat[k] = v
    return flat
