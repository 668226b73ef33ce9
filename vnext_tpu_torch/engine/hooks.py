"""Training hooks: step timer, learning-rate tracker, periodic writers,
checkpoints, evaluation, the profiler and PreciseBN.

Counterpart of ``vnext_tpu.engine.hooks``: ``HookBase``, ``IterationTimer``,
``LRTracker``, ``PeriodicWriter``, ``PeriodicCheckpointer``, ``EvalHook``,
``BestCheckpointer``, ``ProfilerHook`` (``torch.profiler`` in place of
``jax.profiler``) and PreciseBN (``update_bn_stats``, ``PreciseBNHook``) on a
torch model's ``nn.BatchNorm*`` modules; checkpoints go through
``checkpoint.checkpointer.Checkpointer``.

PreciseBN keeps the JAX package's statistics: flax's BatchNorm keeps the
biased batch variance, torch's ``running_var`` the unbiased one, so the port
reads each batch's mean and biased variance off the BatchNorm inputs and
never through torch's running update.
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from typing import Any, Callable, Iterable, Optional, Sequence

import torch
from torch import nn

from ..parallel.mesh import is_main_process
from ..utils.events import CommonMetricPrinter, EventWriter, JSONWriter, get_event_storage

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


def metric_writers(cfg) -> list:
    """The entry points' metric writers (the console printer and
    ``metrics.json``) in a ``PeriodicWriter``, on the main process; none on
    the others, whose metrics are the ranks' mean already."""
    if not is_main_process():
        return []
    return [PeriodicWriter([CommonMetricPrinter(cfg.SOLVER.MAX_ITER),
                            JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json"))])]


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


class ProfilerHook(HookBase):
    """A ``torch.profiler`` trace (CPU and, where there is one, CUDA activity) of
    the steps ``[start_iter, start_iter + num_steps)``, written as one Chrome
    trace ``trace_<start_iter>.json`` into ``output_dir``; stopped after
    training if the run ends inside the window."""

    def __init__(self, output_dir: str, start_iter: int = 10, num_steps: int = 5):
        self._dir = output_dir
        self._start = start_iter
        self._stop = start_iter + num_steps
        self._profiler = None

    def before_step(self):
        if self.trainer.iter == self._start and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.__enter__()

    def after_step(self):
        if self.trainer.iter + 1 >= self._stop:
            self._finish()

    def after_train(self):
        self._finish()

    def _finish(self):
        if self._profiler is None:
            return
        self._profiler.__exit__(None, None, None)
        os.makedirs(self._dir, exist_ok=True)
        path = os.path.join(self._dir, f"trace_{self._start}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        logger.info("Profiler trace written to %s", path)


def _batch_norms(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]


@torch.no_grad()
def update_bn_stats(model: nn.Module, batches: Iterable[Any],
                    forward: Optional[Callable[[nn.Module, Any], Any]] = None) -> int:
    """PreciseBN (detectron2's hook, fvcore's ``update_bn_stats``): run the
    model in training mode over ``batches`` (``forward(model, batch)``, default
    ``model(batch)``) and set every BatchNorm's ``running_mean`` /
    ``running_var`` to the plain average over the batches of each batch's mean
    and biased variance, as the JAX package recovers them from flax's update.
    The model's mode and each BatchNorm's ``num_batches_tracked`` are restored.
    Returns the number of batches (at least one is needed)."""
    norms = _batch_norms(model)
    sums = {bn: [torch.zeros_like(bn.running_mean, dtype=torch.float32),
                 torch.zeros_like(bn.running_var, dtype=torch.float32)] for bn in norms}

    def record(bn, inputs):
        x = inputs[0].float()
        dims = [d for d in range(x.dim()) if d != 1]
        sums[bn][0] += x.mean(dim=dims)
        sums[bn][1] += x.var(dim=dims, correction=0)

    handles = [bn.register_forward_pre_hook(record) for bn in norms]
    tracked = {bn: bn.num_batches_tracked.clone() for bn in norms if bn.num_batches_tracked is not None}
    was_training = model.training
    model.train()
    n = 0
    try:
        for batch in batches:
            forward(model, batch) if forward is not None else model(batch)
            n += 1
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    if n == 0:
        raise ValueError("update_bn_stats needs at least one batch")
    for bn, (mean, var) in sums.items():
        bn.running_mean.copy_(mean / n)
        bn.running_var.copy_(var / n)
        if bn in tracked:
            bn.num_batches_tracked.copy_(tracked[bn])
    return n


class PreciseBNHook(HookBase):
    """Every ``period`` steps (0: never) and after training, the trainer's
    model's BatchNorm statistics re-estimated by :func:`update_bn_stats` over
    the next ``num_iters`` batches of ``data_loader``; a model with no
    BatchNorm is left alone."""

    def __init__(self, data_loader: Iterable[Any], num_iters: int = 200, period: int = 0,
                 forward: Optional[Callable[[nn.Module, Any], Any]] = None):
        self._loader = data_loader
        self._num_iters = num_iters
        self._period = period
        self._forward = forward

    def _recompute(self):
        model = self.trainer.state.model
        if not _batch_norms(model):
            return
        n = update_bn_stats(model, itertools.islice(iter(self._loader), self._num_iters), self._forward)
        logger.info("PreciseBN: refreshed batch statistics over %d batches", n)

    def after_step(self):
        if self._period and (self.trainer.iter + 1) % self._period == 0:
            self._recompute()

    def after_train(self):
        self._recompute()
