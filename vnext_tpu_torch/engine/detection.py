"""Image detection for the Detectron2 meta-architectures: the train loader,
the batch adapter, the train step and ``do_train_detection``; the test
loader, the per-image runner and the ``--eval-only`` evaluation.

Counterpart of ``vnext_tpu.engine.detection`` (reference surface:
tools/train_net.py and plain_train_net.py do_train / do_test,
engine/defaults.py DefaultPredictor). Serving: each image is resized by its
shortest edge, normalized and padded to ``TPU.TEST_IMAGE_SIZE`` (800 x 1344
in the COCO configs), run through the model's ``inference`` under
``torch.no_grad()`` on the model's device, and its detections rescaled to the
original image, with the masks pasted there, for the evaluator. The JAX
package jits one forward of that fixed size; here the module runs eagerly on
the same padded input. Training: the mapper's fixed-shape samples (padded to
``TPU.TRAIN_IMAGE_SIZE``, ``TPU.MAX_INSTANCES`` ground-truth slots) are
collated, normalized on the card and fed to ``make_train_step`` with every
loss at weight 1 (the JAX step's plain sum of the loss dict).

``GeneralizedRCNN`` (with keypoint R-CNN and Cascade R-CNN), ``ProposalNetwork``,
``RetinaNet`` and ``FCOS`` are ported, each with its row of the JAX package's
per-architecture table (``SPEC``: whether the forward takes the images' true
sizes, and whether it trains on masks); PanopticFPN and SemanticSegmentor
raise in ``models.build_model`` naming their ROADMAP item.
Two choices differ from the JAX package's ``do_train_detection`` (ROADMAP
Queue 3): it initializes on the loader's first batch and trains from its
second, where the port trains from the first; and a resumed run here takes up
the loader's sequence at the step it resumes (the skipped samples make their
random draws and nothing else), where JAX's starts the loader again.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..checkpoint.checkpointer import Checkpointer, load_weights
from ..data.build import PrefetchIterator, TrainingSampler
from ..data.catalog import DatasetCatalog
from ..data.dataset_mapper import _load_image
from ..data.detection_mapper import DetectionDatasetMapper, stack_detection_batch
from ..data.transforms import ClipAugmentation
from ..evaluation.testing import verify_final_loss, verify_results
from ..evaluation.ytvis_eval import build_evaluator
from ..models import DETECTRON2_ARCHITECTURES, build_model
from ..models.cascade_rcnn import STAGE_IOUS
from ..models.rcnn import DetTargets
from ..ops.mask_ops import paste_masks_in_image
from ..solver.build import build_grad_clip, build_lr_schedule, build_lr_scheduler, build_optimizer
from ..utils.events import CommonMetricPrinter, JSONWriter
from .hooks import EvalHook, IterationTimer, LRTracker, PeriodicCheckpointer, PeriodicWriter
from .train_step import TrainState, make_train_step
from .trainer import VISTrainer

# the ported image meta-architectures: does the forward take the true sizes, and does it train on masks
# (the JAX package's table, engine/detection.py _ARCH, less its sem_seg and rng columns: the sem_seg
# architectures are not ported, and every train forward here takes the step's generator)
SPEC = {
    "GeneralizedRCNN": dict(sizes=True, masks=True),
    "ProposalNetwork": dict(sizes=True, masks=False),
    "RetinaNet": dict(sizes=False, masks=False),
    "FCOS": dict(sizes=False, masks=False),
}
PORTED = tuple(SPEC)
# then the JAX package's others (the entry point sends all of them here)
_ARCH = (*PORTED, *DETECTRON2_ARCHITECTURES)


def build_detection_train_loader(cfg, seed: int = 0, start_iter: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite loader of collated train batches of ``DATASETS.TRAIN`` (reference
    data/build.py:378): ``TrainingSampler``'s shuffled indices, the train
    ``DetectionDatasetMapper`` drawing from one ``random.Random(seed * 1000)``,
    ``SOLVER.IMS_PER_BATCH`` samples a batch, made ahead in the prefetch
    thread. From ``start_iter`` on: the samples of the batches before it make
    only their random draws (``mapper.draw``)."""
    dataset_dicts = [d for n in cfg.DATASETS.TRAIN for d in DatasetCatalog.get(n)]
    mapper = DetectionDatasetMapper.from_config(cfg, is_train=True)
    batch_size = max(cfg.SOLVER.IMS_PER_BATCH, 1)
    sampler = TrainingSampler(len(dataset_dicts), seed=seed)

    def gen():
        rng = random.Random(seed * 1000)
        skip = start_iter * batch_size
        batch = []
        for idx in sampler:
            if skip:
                mapper.draw(dataset_dicts[idx], rng)
                skip -= 1
                continue
            batch.append(mapper(dataset_dicts[idx], rng))
            if len(batch) == batch_size:
                yield stack_detection_batch(batch)
                batch = []

    return PrefetchIterator(gen())


def _spec(arch: str, what: str) -> dict:
    if arch not in PORTED:
        raise NotImplementedError(f"{what} MODEL.META_ARCHITECTURE {arch!r}: not ported to vnext_tpu_torch yet "
                                  f"(ROADMAP Queue 1, item {DETECTRON2_ARCHITECTURES.get(arch, '11')})")
    return SPEC[arch]


def make_batch_adapter(cfg, device):
    """Collated batch -> the train forward's inputs on ``device``: images
    normalized [B, H, W, 3], the true sizes [B, 2] where the architecture
    takes them (not RetinaNet's nor FCOS's), ``DetTargets``; then for Mask
    R-CNN the bitmasks [B, K, H, W] as they come (bool), and for keypoint
    R-CNN the keypoints [B, K, num_keypoints, 3] (after a None in the masks'
    place without ``MODEL.MASK_ON``)."""
    arch = cfg.MODEL.META_ARCHITECTURE
    spec = _spec(arch, "training")
    mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32, device=device)
    mask_on = spec["masks"] and cfg.MODEL.MASK_ON
    keypoint_on = arch == "GeneralizedRCNN" and cfg.MODEL.KEYPOINT_ON

    def tensor(a):
        return torch.as_tensor(np.asarray(a)).to(device, non_blocking=True)

    def adapter(batch):
        images = (tensor(batch["image"]).float() - mean) / std
        targets = DetTargets(tensor(batch["labels"]), tensor(batch["boxes"]), tensor(batch["valid"]))
        inputs = (images, tensor(batch["size"]), targets) if spec["sizes"] else (images, targets)
        if mask_on or keypoint_on:
            inputs += (tensor(batch["masks"]) if mask_on else None,)
        return inputs + (tensor(batch["keypoints"]),) if keypoint_on else inputs

    return adapter


def loss_keys(cfg) -> tuple:
    """The train forward's loss keys, each summed at weight 1, in its order."""
    arch = cfg.MODEL.META_ARCHITECTURE
    if arch == "RetinaNet":
        return ("loss_cls", "loss_box_reg")
    if arch == "FCOS":
        return ("loss_fcos_cls", "loss_fcos_loc", "loss_fcos_ctr")
    keys = ("loss_rpn_cls", "loss_rpn_loc")
    if arch != "GeneralizedRCNN":
        return keys
    if cfg.MODEL.ROI_HEADS.NAME == "CascadeROIHeads":
        return keys + tuple(k for i in range(len(STAGE_IOUS))
                            for k in (f"loss_cls_stage{i}", f"loss_box_reg_stage{i}"))
    return (keys + ("loss_cls", "loss_box_reg") + (("loss_mask",) if cfg.MODEL.MASK_ON else ())
            + (("loss_keypoint",) if cfg.MODEL.KEYPOINT_ON else ()))


def make_detection_train_step(cfg, model: torch.nn.Module, optimizer: torch.optim.Optimizer, seed: int = 0):
    """``make_train_step`` with the plain sum of the loss dict (make_detection_train_step
    of the JAX package) and the config's clip."""
    return make_train_step(model, optimizer, {k: 1.0 for k in loss_keys(cfg)}, build_grad_clip(cfg), seed=seed)


def build_detection_test_loader(dataset_name: str) -> List[dict]:
    """Per-image records for evaluation (reference build.py:469)."""
    return DatasetCatalog.get(dataset_name)


class DetectionInference:
    """Per-image runner: resize -> normalize and pad -> forward -> rescale to
    the original coordinates (numpy outputs: boxes, scores, classes, valid,
    masks [D, H, W] bool with ``MODEL.MASK_ON`` and keypoints [D, K, 3] (x, y,
    score) with ``MODEL.KEYPOINT_ON``; a ProposalNetwork's proposal_boxes and
    objectness_logits). ``model`` is in eval mode on its device; the image's
    normalization, the forward and the mask pasting run there. RetinaNet's and
    FCOS's ``inference`` take the images alone."""

    def __init__(self, cfg, model: torch.nn.Module):
        self.arch = cfg.MODEL.META_ARCHITECTURE
        self.spec = _spec(self.arch, "DetectionInference for")
        self.model = model
        self.device = next(model.parameters()).device
        # DetectionDatasetMapper's test-time resize (its targets are not needed to serve)
        self.resize = ClipAugmentation((cfg.INPUT.MIN_SIZE_TEST,), cfg.INPUT.MAX_SIZE_TEST, flip=False,
                                       crop_type=None, is_train=False)
        self.mean = torch.tensor(cfg.MODEL.PIXEL_MEAN, dtype=torch.float32, device=self.device)
        self.std = torch.tensor(cfg.MODEL.PIXEL_STD, dtype=torch.float32, device=self.device)
        self.target_size = tuple(cfg.TPU.TEST_IMAGE_SIZE)

    def preprocess(self, record: dict):
        """(images [1, th, tw, 3] normalized and padded with zeros, sizes [1, 2],
        both on the model's device; the resized (h, w); the original (h, w))."""
        img = _load_image(record["file_name"]) if "file_name" in record else record["image"]
        oh, ow = record.get("height", img.shape[0]), record.get("width", img.shape[1])
        resized = self.resize.build(img.shape[0], img.shape[1], random.Random(0)).apply_image(img)
        th, tw = self.target_size
        h, w = min(resized.shape[0], th), min(resized.shape[1], tw)
        pixels = torch.from_numpy(np.array(resized[:h, :w])).to(self.device)
        images = torch.zeros((1, th, tw, 3), dtype=torch.float32, device=self.device)
        images[0, :h, :w] = (pixels.float() - self.mean) / self.std
        sizes = torch.tensor([[h, w]], dtype=torch.int32, device=self.device)
        return images, sizes, (h, w), (oh, ow)

    @torch.no_grad()
    def __call__(self, record: dict) -> dict:
        images, sizes, (h, w), (oh, ow) = self.preprocess(record)
        out = self.model.inference(images, sizes) if self.spec["sizes"] else self.model.inference(images)
        sx, sy = ow / max(w, 1), oh / max(h, 1)
        scale = torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=self.device)
        if "proposal_boxes" in out:
            return {"proposal_boxes": (out["proposal_boxes"][0] * scale).cpu().numpy(),
                    "objectness_logits": out["objectness_logits"][0].cpu().numpy()}
        boxes = out["boxes"][0] * scale
        result = {"boxes": boxes, "scores": out["scores"][0], "classes": out["classes"][0],
                  "valid": out["valid"][0]}
        if "mask_probs" in out:
            result["masks"] = paste_masks_in_image(out["mask_probs"][0], boxes, (oh, ow))
        if "keypoints" in out:
            result["keypoints"] = out["keypoints"][0] * torch.tensor([sx, sy, 1.0], device=self.device)
        return {k: v.cpu().numpy() for k, v in result.items()}


def _resize_nearest(arr: np.ndarray, shape) -> np.ndarray:
    """Nearest resize of a label map to ``shape`` (floor of i * in / out)."""
    oh, ow = shape
    ys = (np.arange(oh) * arr.shape[0] / oh).astype(np.int64).clip(0, arr.shape[0] - 1)
    xs = (np.arange(ow) * arr.shape[1] / ow).astype(np.int64).clip(0, arr.shape[1] - 1)
    return arr[ys][:, xs]


def do_eval_detection(cfg, model: Optional[torch.nn.Module] = None,
                      device: Optional[torch.device] = None) -> Dict[str, dict]:
    """--eval-only for the image meta-architectures (plain_train_net.py
    do_test): {dataset: the evaluator's results} for each ``DATASETS.TEST``
    dataset. Without ``model`` one is built from ``cfg`` on ``device`` with
    seeded weights, then ``MODEL.WEIGHTS`` loaded if set; a given model is
    evaluated in eval mode and put back in its mode after. The entry point
    (``tools/train_net.run``) holds the first dataset's results to
    ``TEST.EXPECTED_RESULTS``. A ProposalNetwork with a test set raises:
    neither package has an evaluator for proposals."""
    if cfg.MODEL.META_ARCHITECTURE == "ProposalNetwork" and cfg.DATASETS.TEST:
        raise NotImplementedError(
            "evaluating a ProposalNetwork: neither package has an evaluator for proposals (the JAX package's "
            "DetectionInference calls ProposalNetwork.inference, which its model does not define); set "
            "DATASETS.TEST \"()\"")
    if model is None:
        model = build_model(cfg, device=device if device is not None else "cuda", seed=0)
        if cfg.MODEL.WEIGHTS:
            load_weights(cfg.MODEL.WEIGHTS, model)
    was_training = model.training
    model.eval()
    try:
        runner = DetectionInference(cfg, model)
        results = {}
        for dataset_name in cfg.DATASETS.TEST:
            evaluator = build_evaluator(cfg, dataset_name)
            evaluator.reset()
            for record in build_detection_test_loader(dataset_name):
                evaluator.process([record], [runner(record)])
            results[dataset_name] = evaluator.evaluate()
    finally:
        model.train(was_training)
    return results


def do_train_detection(cfg, resume: bool = False, device="cuda") -> VISTrainer:
    """Train ``SOLVER.MAX_ITER`` steps (train_net.py do_train): the seeded
    model on ``device``, the config's optimizer, schedule and clip, the hooks
    (timer, learning rate, periodic checkpoints, ``do_eval_detection`` every
    ``TEST.EVAL_PERIOD`` steps and after the last, held to
    ``TEST.EXPECTED_RESULTS``, the metric writers), from the output
    directory's last checkpoint with ``resume``; then ``TEST.FINAL_LOSS_BOUND``."""
    if cfg.MODEL.META_ARCHITECTURE == "ProposalNetwork" and cfg.DATASETS.TEST:
        # what the evaluation after the last step would raise, before the first
        raise NotImplementedError("training a ProposalNetwork with DATASETS.TEST: neither package has an evaluator "
                                  "for proposals; set DATASETS.TEST \"()\"")
    seed = max(cfg.SEED, 0)
    model = build_model(cfg, device=device, seed=seed)
    adapter = make_batch_adapter(cfg, device)
    optimizer = build_optimizer(cfg, model)
    train_step = make_detection_train_step(cfg, model, optimizer, seed=seed)
    checkpointer = Checkpointer(cfg.OUTPUT_DIR)
    state = TrainState.create(model, optimizer, build_lr_scheduler(cfg, optimizer))
    state, start_iter = checkpointer.resume_or_load(cfg.MODEL.WEIGHTS, state, resume=resume)
    loader = build_detection_train_loader(cfg, seed=seed, start_iter=start_iter)
    trainer = VISTrainer(train_step, state, loader, device, batch_adapter=adapter)

    def evaluate():
        results = do_eval_detection(cfg, trainer.state.model)
        if cfg.TEST.EXPECTED_RESULTS and results:
            verify_results(cfg, next(iter(results.values())))
        return results

    trainer.register_hooks([
        IterationTimer(),
        LRTracker(build_lr_schedule(cfg)),
        PeriodicCheckpointer(checkpointer, cfg.SOLVER.CHECKPOINT_PERIOD),
        EvalHook(cfg.TEST.EVAL_PERIOD, evaluate),
        PeriodicWriter([CommonMetricPrinter(cfg.SOLVER.MAX_ITER),
                        JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json"))]),
    ])
    trainer.train(start_iter, cfg.SOLVER.MAX_ITER)
    verify_final_loss(cfg, trainer)
    return trainer
