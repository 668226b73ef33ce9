"""One optimization step of a model whose train forward returns a loss dict
(IDOL, MaskFormer, SeqFormer).

Counterpart of ``vnext_tpu.engine.train_step``: one call does the train forward,
the weighted total over the keys of ``weight_dict``, the backward, the gradient
clip, the AdamW update and the learning-rate step. PyTorch updates the model in
place, so the state holds the model, the optimizer and the scheduler themselves
beside the step count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..solver.build import GradClip


@dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None

    @classmethod
    def create(cls, model, optimizer, scheduler=None) -> "TrainState":
        return cls(step=0, model=model, optimizer=optimizer, scheduler=scheduler)


def checkpoint_state(state: TrainState) -> dict:
    """What a checkpoint holds of ``state`` (``Checkpointer.save`` writes it and
    ``restore_train_state`` reads it back): the step and the model's,
    optimizer's and scheduler's state dicts."""
    return {
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": None if state.scheduler is None else state.scheduler.state_dict(),
    }


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's dropout draws, a function of (seed, step) only, as the JAX
    step folds the step into its key."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    weight_dict: Mapping[str, float], clip: Optional[GradClip] = None,
                    seed: int = 0) -> Callable:
    """Returns ``train_step(state, inputs) -> (state, metrics)``. ``inputs`` is
    the tuple of the train forward's arguments on the model's device (IDOL's
    ``(key_images, key_sizes, ref_images, ref_sizes, det_targets,
    ref_targets)``), the step's generator passed beside them as
    ``generator``; ``metrics`` holds every loss and
    ``total_loss``, detached and still on the device (reading one waits for the
    step). The clip runs over every parameter, frozen ones included."""
    params = list(model.parameters())

    def train_step(state: TrainState, inputs: Tuple) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than this step")
        model.train()
        gen = dropout_generator(seed, state.step, inputs[0].device)
        losses = model(*inputs, generator=gen)
        total = sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict)
        model.zero_grad(set_to_none=True)
        total.backward()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        if clip is not None:
            metrics["grad_norm"] = clip(params)
        optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        return state, metrics

    return train_step
