"""Training hooks: step timer, learning-rate tracker, periodic writers and
checkpoints.

Counterpart of the parts of ``vnext_tpu.engine.hooks`` the train slice runs
(``HookBase``, ``IterationTimer``, ``LRTracker``, ``PeriodicWriter``,
``PeriodicCheckpointer``); checkpoints are ``torch.save`` files of the trainer's
state. Evaluation, best-checkpoint, profiler and PreciseBN hooks are not ported
yet.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Sequence

import torch

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
    """Every ``period`` steps and after the last, ``torch.save`` of the trainer's
    ``checkpoint_state()`` to ``save_dir/model_{iter:07d}.pth``."""

    def __init__(self, save_dir: str, period: int):
        self._dir = save_dir
        self._period = period

    def after_step(self):
        it = self.trainer.iter
        if (it + 1) % self._period == 0 or it == self.trainer.max_iter - 1:
            os.makedirs(self._dir, exist_ok=True)
            path = os.path.join(self._dir, f"model_{it:07d}.pth")
            torch.save(self.trainer.checkpoint_state(), path)
            logger.info("Saved checkpoint %s", path)
