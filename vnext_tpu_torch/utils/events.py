"""In-process metric storage and its writers.

Counterpart of ``vnext_tpu.utils.events`` (``EventStorage``, ``HistoryBuffer``,
``get_event_storage``, ``JSONWriter``, ``CommonMetricPrinter``), the detectron2
surface: a training loop opens an ``EventStorage``, hooks and the trainer put
scalars into it, and writers read the latest values.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from collections import defaultdict, deque
from typing import Dict, List, Optional

_CURRENT_STORAGE_STACK: List["EventStorage"] = []


def get_event_storage() -> "EventStorage":
    if not _CURRENT_STORAGE_STACK:
        raise RuntimeError("get_event_storage() called outside 'with EventStorage(...)'")
    return _CURRENT_STORAGE_STACK[-1]


class HistoryBuffer:
    """A scalar series with a bounded window for median / average smoothing."""

    def __init__(self, window_size: int = 20):
        self._window = deque(maxlen=window_size)
        self._count = 0
        self._global_avg = 0.0
        self._latest = float("nan")

    def update(self, value: float) -> None:
        value = float(value)
        self._window.append(value)
        self._count += 1
        self._global_avg += (value - self._global_avg) / self._count
        self._latest = value

    def latest(self) -> float:
        return self._latest

    def values(self) -> List[float]:
        """The values in the window, oldest first."""
        return list(self._window)

    def median(self, window_size: Optional[int] = None) -> float:
        vals = sorted(list(self._window)[-(window_size or len(self._window)):])
        return vals[len(vals) // 2] if vals else float("nan")

    def global_avg(self) -> float:
        return self._global_avg

    def count(self) -> int:
        return self._count


class EventStorage:
    """Scoped scalar store used by the training loop and its hooks."""

    def __init__(self, start_iter: int = 0, window_size: int = 20):
        self._history: Dict[str, HistoryBuffer] = defaultdict(lambda: HistoryBuffer(window_size))
        self._smoothing_hints: Dict[str, bool] = {}
        self._latest_scalars: Dict[str, tuple] = {}
        self.iter = start_iter

    def put_scalar(self, name: str, value: float, smoothing_hint: bool = True) -> None:
        value = float(value)
        self._history[name].update(value)
        self._latest_scalars[name] = (value, self.iter)
        existing = self._smoothing_hints.get(name)
        if existing is not None and existing != smoothing_hint:
            raise ValueError(f"Scalar {name} was put with inconsistent smoothing_hint")
        self._smoothing_hints[name] = smoothing_hint

    def history(self, name: str) -> HistoryBuffer:
        if name not in self._history:
            raise KeyError(f"No history metric '{name}'")
        return self._history[name]

    def histories(self) -> Dict[str, HistoryBuffer]:
        return self._history

    def latest(self) -> Dict[str, tuple]:
        return self._latest_scalars

    def latest_with_smoothing_hint(self, window_size: int = 20) -> Dict[str, tuple]:
        return {k: (self._history[k].median(window_size) if self._smoothing_hints.get(k) else v, itr)
                for k, (v, itr) in self._latest_scalars.items()}

    def __enter__(self) -> "EventStorage":
        _CURRENT_STORAGE_STACK.append(self)
        return self

    def __exit__(self, *args) -> None:
        if _CURRENT_STORAGE_STACK[-1] is not self:
            raise RuntimeError("EventStorage scopes closed out of order")
        _CURRENT_STORAGE_STACK.pop()


class EventWriter:
    def write(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JSONWriter(EventWriter):
    """Appends the latest scalars of each new iteration to a jsonl file (metrics.json)."""

    def __init__(self, json_file: str, window_size: int = 20):
        os.makedirs(os.path.dirname(json_file) or ".", exist_ok=True)
        self._file = open(json_file, "a")
        self._window_size = window_size
        self._last_write = -1

    def write(self) -> None:
        to_save = defaultdict(dict)
        for k, (v, itr) in get_event_storage().latest_with_smoothing_hint(self._window_size).items():
            if itr > self._last_write:
                to_save[itr][k] = v
        if to_save:
            self._last_write = max(to_save)
        for itr in sorted(to_save):
            self._file.write(json.dumps({**to_save[itr], "iteration": itr}, sort_keys=True) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()


class CommonMetricPrinter(EventWriter):
    """Logs ETA, smoothed losses, step time and learning rate."""

    def __init__(self, max_iter: Optional[int] = None, window_size: int = 20):
        self.logger = logging.getLogger("vnext_tpu_torch")
        self._max_iter = max_iter
        self._window_size = window_size

    def write(self) -> None:
        storage = get_event_storage()
        iteration = storage.iter
        msg = f"iter: {iteration}"
        iter_time = None
        if "time" in storage.histories():
            iter_time = storage.history("time").global_avg()
            if self._max_iter is not None:
                eta = datetime.timedelta(seconds=int(iter_time * (self._max_iter - iteration - 1)))
                msg = f"eta: {eta}  " + msg
        losses = [f"{k}: {v.median(self._window_size):.4g}"
                  for k, v in storage.histories().items() if "loss" in k]
        if losses:
            msg += "  " + "  ".join(losses)
        if iter_time is not None:
            msg += f"  time: {iter_time:.4f}"
        lr = storage.history("lr").latest() if "lr" in storage.histories() else None
        msg += f"  lr: {lr:.5g}" if lr is not None else "  lr: N/A"
        self.logger.info(msg)
