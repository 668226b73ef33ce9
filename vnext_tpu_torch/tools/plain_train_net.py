"""A minimal explicit IDOL training loop without the trainer and its hooks.

Counterpart of the JAX package's ``tools/plain_train_net.py`` (CLI surface
parity with tools/plain_train_net.py in the reference: the "write your own
loop" template, do_train:113 style), with ``tools/train_net.py``'s flags:

    python -m vnext_tpu_torch.tools.plain_train_net --config-file configs/idol/ytvis19_r50.yaml \\
        [--resume] [--eval-only] MODEL.WEIGHTS "" OUTPUT_DIR out

Everything is spelled out inline: the model, the optimizer, schedule and clip,
the clip loader, the train step, a check that the loss is finite and a log
line every 20 iterations, a checkpoint every ``SOLVER.CHECKPOINT_PERIOD``
iterations and after the last (``model_<iterations done>.pth``), and
``--resume`` from the output directory's ``last_checkpoint``. ``--eval-only``
runs ``train_net.do_eval``. The run is on the card unless the config says
``MODEL.DEVICE cpu``; with no CUDA device visible it raises.
"""

from __future__ import annotations

import logging
import math
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..data import CocoClipDatasetMapper, build_vis_train_loader
from ..engine.train_step import TrainState, checkpoint_state, make_train_step
from ..engine.trainer import batch_to_model_inputs
from ..models.criterion import default_weight_dict
from ..models.idol import build_idol_model
from ..solver.build import build_grad_clip, build_lr_scheduler, build_optimizer
from ..utils.events import EventStorage
from . import train_net

logger = logging.getLogger("vnext_tpu_torch")

LOG_PERIOD = 20


def do_train(cfg, resume: bool = False, model: Optional[torch.nn.Module] = None
             ) -> Tuple[TrainState, List[Dict[str, float]]]:
    """Train IDOL for ``SOLVER.MAX_ITER`` iterations; returns the state and
    each step's metrics on the host. ``model`` (an IDOL on the config's device)
    replaces the seeded one ``build_idol_model`` makes."""
    train_net._register_datasets(cfg)
    device = train_net.resolve_device(cfg)
    seed = max(cfg.SEED, 0)
    if model is None:
        model = build_idol_model(cfg, device=device, seed=seed)
    c = cfg.MODEL.IDOL
    weight_dict = default_weight_dict(
        class_weight=c.CLASS_WEIGHT, l1_weight=c.L1_WEIGHT, giou_weight=c.GIOU_WEIGHT,
        mask_weight=c.MASK_WEIGHT, dice_weight=c.DICE_WEIGHT, reid_weight=c.REID_WEIGHT,
        dec_layers=c.DEC_LAYERS, deep_supervision=c.DEEP_SUPERVISION,
    )
    optimizer = build_optimizer(cfg, model)
    step_fn = make_train_step(model, optimizer, weight_dict, build_grad_clip(cfg), seed=seed)
    state = TrainState.create(model, optimizer, build_lr_scheduler(cfg, optimizer))

    checkpointer = Checkpointer(cfg.OUTPUT_DIR)
    state, start_iter = checkpointer.resume_or_load(cfg.MODEL.WEIGHTS, state, resume=resume)
    mapper = CocoClipDatasetMapper.from_config(cfg, is_train=True) if cfg.INPUT.COCO_PRETRAIN else None
    data_iter = iter(build_vis_train_loader(cfg, mapper=mapper, seed=seed))
    max_iter = cfg.SOLVER.MAX_ITER
    logger.info("Starting plain training from iter %d to %d", start_iter, max_iter)
    history = []
    with EventStorage(start_iter) as storage:
        t0 = time.perf_counter()
        for it in range(start_iter, max_iter):
            storage.iter = it
            inputs = batch_to_model_inputs(next(data_iter), cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, device)
            state, metrics = step_fn(state, inputs)
            host = {k: float(v) for k, v in metrics.items()}   # waits for the step
            if not math.isfinite(host["total_loss"]):
                raise FloatingPointError(f"non-finite loss at iter {it + 1}: {host}")
            history.append(host)
            for k, v in host.items():
                storage.put_scalar(k, v)
            done = it + 1
            if done % LOG_PERIOD == 0 or done == max_iter:
                rate = (done - max(start_iter, done - LOG_PERIOD)) / max(time.perf_counter() - t0, 1e-9)
                t0 = time.perf_counter()
                logger.info("iter %d  %s  (%.2f it/s)", done,
                            "  ".join(f"{k}={v:.4f}" for k, v in sorted(host.items())), rate)
            if done % cfg.SOLVER.CHECKPOINT_PERIOD == 0 or done == max_iter:
                checkpointer.save(f"model_{done:07d}", checkpoint_state(state))
    return state, history


def main(argv=None):
    """``train_net``'s command line: ``--eval-only`` returns ``train_net.do_eval``'s
    results, else ``do_train``'s (state, per-step metrics)."""
    args = train_net.default_argument_parser().parse_args(argv)
    cfg = train_net.setup(args)
    if cfg.MODEL.META_ARCHITECTURE != "IDOL":
        raise NotImplementedError(f"MODEL.META_ARCHITECTURE {cfg.MODEL.META_ARCHITECTURE!r}: the plain loop "
                                  "trains IDOL, as the JAX package's does")
    if args.eval_only:
        return train_net.do_eval(cfg)
    return do_train(cfg, resume=args.resume)


if __name__ == "__main__":
    main(sys.argv[1:])
