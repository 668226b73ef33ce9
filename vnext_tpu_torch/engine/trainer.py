"""Hook-driven training loop.

Counterpart of ``vnext_tpu.engine.trainer`` (``TrainerBase``,
``batch_to_model_inputs``, ``VISTrainer``): the loop moves each collated batch
to the card, runs one train step, and hands each step's metrics to the event
storage one step late, so that reading them waits for a step the card has
already finished and the next step is queued first. A non-finite total loss
raises ``FloatingPointError``.
"""

from __future__ import annotations

import logging
import weakref
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..models.criterion import Targets
from ..utils.events import EventStorage, get_event_storage
from .hooks import HookBase
from .train_step import TrainState

logger = logging.getLogger("vnext_tpu_torch")

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


class TrainerBase:
    def __init__(self):
        self._hooks: List[HookBase] = []
        self.iter = 0
        self.start_iter = 0
        self.max_iter = 0
        self.storage: Optional[EventStorage] = None

    def register_hooks(self, hooks: Iterable[Optional[HookBase]]) -> None:
        for h in hooks:
            if h is None:
                continue
            if not isinstance(h, HookBase):
                raise TypeError(f"{h!r} is not a HookBase")
            h.trainer = weakref.proxy(self)
            self._hooks.append(h)

    def train(self, start_iter: int, max_iter: int) -> None:
        logger.info("Starting training from iteration %d", start_iter)
        self.iter = self.start_iter = start_iter
        self.max_iter = max_iter
        with EventStorage(start_iter) as self.storage:
            try:
                self.before_train()
                for self.iter in range(start_iter, max_iter):
                    self.storage.iter = self.iter
                    self.before_step()
                    self.run_step()
                    self.after_step()
                self.iter += 1
            finally:
                self.after_train()

    def before_train(self):
        for h in self._hooks:
            h.before_train()

    def after_train(self):
        if self.storage is not None:
            self.storage.iter = self.iter
        for h in self._hooks:
            h.after_train()

    def before_step(self):
        for h in self._hooks:
            h.before_step()

    def after_step(self):
        for h in self._hooks:
            h.after_step()

    def run_step(self):
        raise NotImplementedError


def batch_to_model_inputs(batch: Dict[str, np.ndarray], pixel_mean, pixel_std, device) -> tuple:
    """A collated loader batch (numpy: ``key_image`` / ``ref_image`` uint8 or float
    [B, H, W, 3], ``*_size`` [B, 2], ``*_labels``, ``*_boxes``, ``*_masks_s4``,
    ``*_valid``, ``*_inst_id``) -> the train forward's arguments on ``device``,
    images normalized."""

    def tensor(a):
        return torch.as_tensor(np.asarray(a)).to(device, non_blocking=True)

    def targets(prefix):
        return Targets(*(tensor(batch[f"{prefix}_{k}"]) for k in Targets._fields))

    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=device)

    def norm(img):
        return (tensor(img).float() - mean) / std

    return (norm(batch["key_image"]), tensor(batch["key_size"]),
            norm(batch["ref_image"]), tensor(batch["ref_size"]),
            targets("key"), targets("ref"))


class VISTrainer(TrainerBase):
    """Data -> train step -> metrics. ``batch_adapter(batch)`` makes the model's
    inputs on the device from a collated batch; without it the batch is IDOL's
    clip format (``batch_to_model_inputs``)."""

    def __init__(self, train_step_fn, state: TrainState, data_iter, device,
                 pixel_mean=PIXEL_MEAN, pixel_std=PIXEL_STD, batch_adapter=None):
        super().__init__()
        self._train_step = train_step_fn
        self.state = state
        self._data_iter = iter(data_iter)
        self._device = torch.device(device)
        self._pixel_mean = pixel_mean
        self._pixel_std = pixel_std
        self._batch_adapter = batch_adapter
        self._pending_metrics = None

    def run_step(self):
        batch = next(self._data_iter)
        if self._batch_adapter is not None:
            inputs = self._batch_adapter(batch)
        else:
            inputs = batch_to_model_inputs(batch, self._pixel_mean, self._pixel_std, self._device)
        self.state, metrics = self._train_step(self.state, inputs)
        # the previous step's metrics, now that this step is queued
        if self._pending_metrics is not None:
            self._write_metrics(self._pending_metrics)
        self._pending_metrics = metrics

    def _write_metrics(self, metrics: Dict[str, torch.Tensor]):
        host = {k: float(v) for k, v in metrics.items()}
        if not np.isfinite(host.get("total_loss", 0.0)):
            raise FloatingPointError(f"Loss became infinite or NaN at iteration={self.iter}: {host}")
        storage = get_event_storage()
        for k, v in host.items():
            storage.put_scalar(k, v, smoothing_hint=True)

    def after_train(self):
        if self._pending_metrics is not None:
            # the last step's metrics land at iteration max_iter, where the
            # writers' final flush finds them
            if self.storage is not None:
                self.storage.iter = self.iter
            try:
                self._write_metrics(self._pending_metrics)
            except FloatingPointError:
                logger.exception("the last step's loss is not finite")
            self._pending_metrics = None
        super().after_train()

    def checkpoint_state(self) -> dict:
        s = self.state
        return {
            "step": s.step,
            "model": s.model.state_dict(),
            "optimizer": s.optimizer.state_dict(),
            "scheduler": None if s.scheduler is None else s.scheduler.state_dict(),
        }
