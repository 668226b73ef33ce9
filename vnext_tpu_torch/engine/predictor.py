"""Predictor conveniences (reference surface: engine/defaults.py:280
DefaultPredictor and demo/predictor.py:132 AsyncPredictor), the port's copy of
``vnext_tpu.engine.predictor``.

``AsyncPredictor`` pipelines host pre/post-processing with device compute using
a worker thread (one card here; the reference used one process per GPU) and an
ordered result queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict


class DefaultPredictor:
    """Single-input callable around an inference fn + preprocessing."""

    def __init__(self, infer_fn: Callable, preprocess: Callable, postprocess: Callable):
        self._infer = infer_fn
        self._pre = preprocess
        self._post = postprocess

    def __call__(self, inputs) -> Any:
        args = self._pre(inputs)
        out = self._infer(*args)
        return self._post(out, inputs)


class AsyncPredictor:
    """Pipeline inputs through a background worker, preserving order; an error
    in the worker is raised at the ``get()`` of its input."""

    def __init__(self, predictor: Callable, queue_size: int = 3):
        self._predictor = predictor
        self._tasks: queue.Queue = queue.Queue(maxsize=queue_size)
        self._results: Dict[int, Any] = {}
        self._cond = threading.Condition()
        self._put_idx = 0
        self._get_idx = 0
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while True:
            item = self._tasks.get()
            if item is None:
                return
            idx, data = item
            try:
                result = self._predictor(data)
            except Exception as e:  # surface errors at get() time
                result = e
            with self._cond:
                self._results[idx] = result
                self._cond.notify_all()

    def put(self, data) -> None:
        self._tasks.put((self._put_idx, data))
        self._put_idx += 1

    def get(self) -> Any:
        with self._cond:
            while self._get_idx not in self._results:
                self._cond.wait()
            result = self._results.pop(self._get_idx)
            self._get_idx += 1
        if isinstance(result, Exception):
            raise result
        return result

    def __len__(self) -> int:
        return self._put_idx - self._get_idx

    def shutdown(self) -> None:
        self._tasks.put(None)
