"""Checkpoint save and resume of the trainer's state.

Counterpart of ``vnext_tpu.checkpoint.checkpointer`` (detectron2's
``DetectionCheckpointer`` protocol) on ``torch.save`` / ``torch.load``, where
the JAX package uses orbax: ``save`` writes ``<name>.pth`` with the state
``VISTrainer.checkpoint_state()`` gives (step, model, optimizer, scheduler)
and a ``last_checkpoint`` marker naming it; ``resume_or_load`` restores that
whole state when asked to resume and a marker is there, else loads model
weights only (``load_weights``: the port's own files, or a reference ``.pth``
or detectron2 ``.pkl`` through ``checkpoint/torch_import.py``).
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Tuple

import torch
from torch import nn

from ..engine.train_step import TrainState
from .torch_import import load_reference_weights, load_torch_state_dict

logger = logging.getLogger("vnext_tpu_torch")

LAST_CHECKPOINT_FILE = "last_checkpoint"


class Checkpointer:
    def __init__(self, save_dir: str):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)

    # -------------------------------------------------------------- core IO
    def save(self, name: str, state: dict) -> str:
        """``torch.save`` of ``state`` to ``<save_dir>/<name>.pth`` (written
        under a temporary name, then renamed), and the marker names it."""
        path = os.path.join(self.save_dir, f"{name}.pth")
        fd, tmp = tempfile.mkstemp(suffix=".pth", dir=self.save_dir)
        os.close(fd)
        try:
            torch.save(state, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        with open(os.path.join(self.save_dir, LAST_CHECKPOINT_FILE), "w") as f:
            f.write(os.path.basename(path))
        logger.info("Saved checkpoint to %s", path)
        return path

    def load(self, path: str) -> dict:
        """A checkpoint this class saved, its tensors on the CPU."""
        return torch.load(path, map_location="cpu", weights_only=True)

    # -------------------------------------------------------------- protocol
    def has_checkpoint(self) -> bool:
        return os.path.exists(os.path.join(self.save_dir, LAST_CHECKPOINT_FILE))

    def get_checkpoint_file(self):
        """The path the marker names, or None without a marker."""
        marker = os.path.join(self.save_dir, LAST_CHECKPOINT_FILE)
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            name = f.read().strip()
        return os.path.join(self.save_dir, name)

    def resume_or_load(self, weights_path: str, state: TrainState,
                       resume: bool = True) -> Tuple[TrainState, int]:
        """Returns (state, start_iter). With ``resume`` and a marker: the model,
        optimizer, scheduler and step of the checkpoint it names, and the loop
        starts at that step; else the weights of ``weights_path`` (if any) and
        step 0. ``state`` is updated in place."""
        if resume and self.has_checkpoint():
            path = self.get_checkpoint_file()
            logger.info("Resuming from %s", path)
            restore_train_state(state, self.load(path))
            return state, state.step
        if weights_path:
            load_weights(weights_path, state.model)
        return state, 0


def restore_train_state(state: TrainState, ckpt: dict) -> None:
    """Load a ``checkpoint_state()`` dict into ``state``'s model, optimizer and
    scheduler (values copied exactly) and set its step."""
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if (state.scheduler is None) != (ckpt["scheduler"] is None):
        raise ValueError("the checkpoint and the state disagree on having a learning-rate scheduler")
    if state.scheduler is not None:
        state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step"])


def load_weights(path: str, model: nn.Module) -> None:
    """Model weights from ``path``: a checkpoint of the port (its ``model``
    entry holds exactly the model's keys), else a reference ``.pth`` or a
    detectron2 ``.pkl`` converted by ``torch_import``. A missing file raises
    ``FileNotFoundError``."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"MODEL.WEIGHTS {path!r} does not exist")
    sd = load_torch_state_dict(path)
    if set(sd) == set(model.state_dict()):
        model.load_state_dict(sd)
        logger.info("Loaded the port's weights from %s", path)
        return
    report = load_reference_weights(path, model)
    logger.info(
        "Imported torch weights: %d matched, %d missing, %d unused, %d shape-mismatched",
        report["matched"], len(report["missing"]), len(report["unused"]), len(report["shape_mismatch"]),
    )
