"""Training hooks: step timer, learning-rate tracker, periodic writers,
checkpoints and evaluation.

Counterpart of the parts of ``vnext_tpu.engine.hooks`` IDOL's entry point runs
(``HookBase``, ``IterationTimer``, ``LRTracker``, ``PeriodicWriter``,
``PeriodicCheckpointer``, ``EvalHook``, ``BestCheckpointer``); checkpoints go
through ``checkpoint.checkpointer.Checkpointer``. The profiler and PreciseBN
hooks are not ported yet.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Sequence

from ..utils.events import EventWriter, get_event_storage

logger = logging.getLogger("vnext_tpu_torch")


class HookBase:
    trainer = None  # set by TrainerBase.register_hooks

    def before_train(self):
        pass

    def after_train(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass


class IterationTimer(HookBase):
    """Host time of each step after ``warmup_iter`` steps, as the scalar ``time``.
    The trainer reads each step's metrics one step late, so in a steady run the
    host waits for the previous step inside this window and the times follow
    the card's."""

    def __init__(self, warmup_iter: int = 3):
        self._warmup_iter = warmup_iter
        self._start_time = None
        self._step_start = None

    def before_train(self):
        self._start_time = time.perf_counter()

    def before_step(self):
        self._step_start = time.perf_counter()

    def after_step(self):
        dt = time.perf_counter() - self._step_start
        if self.trainer.iter >= self.trainer.start_iter + self._warmup_iter:
            get_event_storage().put_scalar("time", dt, smoothing_hint=True)

    def after_train(self):
        total = time.perf_counter() - self._start_time
        n = max(self.trainer.iter - self.trainer.start_iter, 1)
        logger.info("Total training time: %.1fs (%.4fs / it)", total, total / n)


class LRTracker(HookBase):
    """The learning rate of each step, from the schedule (a function of the step)."""

    def __init__(self, schedule: Callable[[int], float]):
        self._schedule = schedule

    def after_step(self):
        get_event_storage().put_scalar("lr", float(self._schedule(self.trainer.iter)),
                                       smoothing_hint=False)


class PeriodicWriter(HookBase):
    def __init__(self, writers: Sequence[EventWriter], period: int = 20):
        self._writers = writers
        self._period = period

    def after_step(self):
        it = self.trainer.iter
        if (it + 1) % self._period == 0 or it == self.trainer.max_iter - 1:
            for w in self._writers:
                w.write()

    def after_train(self):
        for w in self._writers:
            w.write()
            w.close()


class PeriodicCheckpointer(HookBase):
    """Every ``period`` steps and after the last, the trainer's
    ``checkpoint_state()`` through ``checkpointer.save("model_{iter:07d}", ...)``,
    which writes ``model_{iter:07d}.pth`` and the ``last_checkpoint`` marker."""

    def __init__(self, checkpointer, period: int):
        self._checkpointer = checkpointer
        self._period = period

    def after_step(self):
        it = self.trainer.iter
        if (it + 1) % self._period == 0 or it == self.trainer.max_iter - 1:
            self._checkpointer.save(f"model_{it:07d}", self.trainer.checkpoint_state())


class EvalHook(HookBase):
    """``eval_fn()`` every ``period`` steps (not at the last) and after training
    (even with ``period`` 0); its results' numbers go to the event storage
    under flattened keys (``segm/AP``)."""

    def __init__(self, period: int, eval_fn: Callable[[], Optional[dict]]):
        self._period = period
        self._fn = eval_fn

    def _do_eval(self):
        results = self._fn()
        if results:
            storage = get_event_storage()
            for k, v in _flatten(results):
                storage.put_scalar(k, v, smoothing_hint=False)

    def after_step(self):
        if self._period > 0 and (self.trainer.iter + 1) % self._period == 0:
            if self.trainer.iter != self.trainer.max_iter - 1:
                self._do_eval()

    def after_train(self):
        if self.trainer.iter >= self.trainer.max_iter - 1:
            self._do_eval()


class BestCheckpointer(HookBase):
    """Every ``eval_period`` steps, save ``model_best`` when the storage's latest
    ``val_metric`` is better than the best seen ("max" or "min")."""

    def __init__(self, eval_period: int, checkpointer, val_metric: str, mode: str = "max"):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self._period = eval_period
        self._checkpointer = checkpointer
        self._metric = val_metric
        self._mode = mode
        self._best = None

    def after_step(self):
        if self._period <= 0 or (self.trainer.iter + 1) % self._period != 0:
            return
        latest = get_event_storage().latest().get(self._metric)
        if latest is None:
            return
        value = latest[0]
        better = (self._best is None or (self._mode == "max" and value > self._best)
                  or (self._mode == "min" and value < self._best))
        if better:
            self._best = value
            self._checkpointer.save("model_best", self.trainer.checkpoint_state())
            logger.info("New best %s=%.4f at iter %d", self._metric, value, self.trainer.iter)


def _flatten(d, prefix=""):
    """(key, float) for each number of a nested dict, keys joined by "/"."""
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, key + "/")
        else:
            try:
                yield key, float(v)
            except (TypeError, ValueError):
                pass
