"""MinVIS / Mask2Former (+ InstMove motion) training and evaluation entry point, on one NVIDIA GPU.

Counterpart of ``tools/train_net_video.py`` (the JAX package's, with
detectron2's command line):

    python -m vnext_tpu_torch.tools.train_net_video --config-file configs/minvis/ovis_r50.yaml \\
        --eval-only MODEL.WEIGHTS model.pth OUTPUT_DIR out
    python -m vnext_tpu_torch.tools.train_net_video --config-file configs/minvis/ovis_r50.yaml \\
        [--resume] OUTPUT_DIR out

``--eval-only`` runs ``MinVISVideoInference`` (windows of
``MODEL.MASK_FORMER.TEST.WINDOW_SIZE`` frames, queries aligned across frames,
with InstMove's motion cost when ``MODEL.INSTMOVE.ENABLED``) on every video of
each ``DATASETS.TEST`` dataset through ``inference_on_dataset`` and the YTVIS
evaluator. Without it the clip loader feeds ``VISTrainer``, whose batch adapter
makes the key and reference frames of each clip one batch of frames for the
frame-level ``MaskFormer``; ``--resume`` continues from the output directory's
``last_checkpoint``.

The run is on the card unless the config says ``MODEL.DEVICE cpu``, as in
``tools/train_net.py``, whose command line (``run``), setup of the config and
the device, and dataset registration this module shares.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..checkpoint.checkpointer import Checkpointer, load_weights
from ..config import add_maskformer_config
from ..data import build_vis_test_loader, build_vis_train_loader
from ..engine.hooks import EvalHook, IterationTimer, LRTracker, PeriodicCheckpointer, PeriodicWriter
from ..engine.minvis_inference import MinVISVideoInference
from ..engine.train_step import TrainState, make_train_step
from ..engine.trainer import VISTrainer
from ..evaluation.evaluator import inference_on_dataset
from ..evaluation.testing import verify_final_loss
from ..evaluation.ytvis_eval import build_evaluator
from ..models.instmove import build_instmove_model, check_mask_size
from ..models.mask2former import MaskTargets, build_maskformer_model, maskformer_weight_dict
from ..solver.build import build_grad_clip, build_lr_schedule, build_lr_scheduler, build_optimizer
from ..utils.events import CommonMetricPrinter, JSONWriter
from . import train_net
from .train_net import _register_datasets, resolve_device


def setup(args):
    """``train_net``'s setup with ``add_maskformer_config``'s keys."""
    return train_net.setup(args, add_maskformer_config)


def build_motion(cfg, device):
    """The InstMove predictor of ``MODEL.INSTMOVE.*`` with seeded weights, then
    ``MODEL.INSTMOVE.WEIGHTS`` loaded if set."""
    motion = build_instmove_model(cfg, device=device, seed=0)
    if cfg.MODEL.INSTMOVE.WEIGHTS:
        load_weights(cfg.MODEL.INSTMOVE.WEIGHTS, motion)
    return motion


def do_eval(cfg, model=None):
    """{dataset: the evaluator's results} for each ``DATASETS.TEST`` dataset.
    ``model`` (a MaskFormer, in either mode) is evaluated in eval mode and put
    back in its mode after; without it one is built from ``cfg`` with seeded
    weights, then ``MODEL.WEIGHTS`` loaded if set. The runner takes its frame
    sizes from its defaults, as the JAX package's does; with InstMove they
    must give mask sides that are multiples of 16, else a ``ValueError``
    before any video (ROADMAP Queue 3, item 3)."""
    _register_datasets(cfg)
    device = resolve_device(cfg)
    if model is None:
        model = build_maskformer_model(cfg, device=device, seed=0)
        if cfg.MODEL.WEIGHTS:
            load_weights(cfg.MODEL.WEIGHTS, model)
    motion = build_motion(cfg, device) if cfg.MODEL.INSTMOVE.ENABLED else None
    was_training = model.training
    model.eval()  # the inference path: K1 and K3 on the card, not K4
    try:
        results = {}
        for dataset_name in cfg.DATASETS.TEST:
            runner = MinVISVideoInference(
                model, window_size=cfg.MODEL.MASK_FORMER.TEST.WINDOW_SIZE, motion_predictor=motion,
                pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN), pixel_std=tuple(cfg.MODEL.PIXEL_STD))
            if motion is not None:
                check_mask_size(runner.target_size[0] // 4, runner.target_size[1] // 4)
            evaluator = build_evaluator(cfg, dataset_name, cfg.OUTPUT_DIR)
            results[dataset_name] = inference_on_dataset(runner, build_vis_test_loader(cfg, dataset_name),
                                                         evaluator)
    finally:
        model.train(was_training)
    return results


def minvis_batch_adapter(pixel_mean, pixel_std, device):
    """A collated clip batch -> ``MaskFormer.forward``'s (frames, sizes,
    ``MaskTargets``) on ``device``: the key frames, then the reference frames,
    as one batch of frames (MinVIS trains Mask2Former frame by frame), the
    frames normalized."""
    device = torch.device(device)
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=device)

    def frames(batch, name):
        a = np.concatenate([batch[f"key_{name}"], batch[f"ref_{name}"]])
        return torch.from_numpy(a).to(device, non_blocking=True)

    def adapter(batch):
        x = (frames(batch, "image").float() - mean) / std
        targets = MaskTargets(labels=frames(batch, "labels"), masks_s4=frames(batch, "masks_s4"),
                              valid=frames(batch, "valid"))
        return x, frames(batch, "size"), targets

    return adapter


def do_train(cfg, resume: bool = False) -> VISTrainer:
    """Train the MaskFormer for ``SOLVER.MAX_ITER`` steps with the recipe's
    optimizer, schedule and clip, ``maskformer_weight_dict``'s weights and the
    hooks (timer, learning rate, periodic checkpoints, evaluation, metric
    writers), from the last checkpoint with ``resume``."""
    _register_datasets(cfg)
    device = resolve_device(cfg)
    seed = max(cfg.SEED, 0)
    model = build_maskformer_model(cfg, device=device, seed=seed)
    optimizer = build_optimizer(cfg, model)
    train_step = make_train_step(model, optimizer, maskformer_weight_dict(cfg), build_grad_clip(cfg), seed=seed)
    checkpointer = Checkpointer(cfg.OUTPUT_DIR)
    state = TrainState.create(model, optimizer, build_lr_scheduler(cfg, optimizer))
    state, start_iter = checkpointer.resume_or_load(cfg.MODEL.WEIGHTS, state, resume=resume)

    loader = build_vis_train_loader(cfg, seed=seed)
    trainer = VISTrainer(train_step, state, loader, device,
                         batch_adapter=minvis_batch_adapter(cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, device))
    trainer.register_hooks([
        IterationTimer(),
        LRTracker(build_lr_schedule(cfg)),
        PeriodicCheckpointer(checkpointer, cfg.SOLVER.CHECKPOINT_PERIOD),
        EvalHook(cfg.TEST.EVAL_PERIOD, lambda: do_eval(cfg, trainer.state.model)),
        PeriodicWriter([CommonMetricPrinter(cfg.SOLVER.MAX_ITER),
                        JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json"))]),
    ])
    trainer.train(start_iter, cfg.SOLVER.MAX_ITER)
    verify_final_loss(cfg, trainer)
    return trainer


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``) and run MinVIS's MaskFormer;
    returns the eval results with ``--eval-only``, else the trainer."""
    return train_net.run(argv, setup, ("MaskFormer",),
               "IDOL runs through vnext_tpu_torch.tools.train_net, and SeqFormer has no entry point in either "
               "package", do_eval, do_train)


if __name__ == "__main__":
    main(sys.argv[1:])
