"""IDOL's and the Detectron2 families' training and evaluation entry point, on one NVIDIA GPU.

Counterpart of ``tools/train_net.py`` (the JAX package's entry point, with
detectron2's command line):

    python -m vnext_tpu_torch.tools.train_net --config-file configs/idol/ytvis19_r50.yaml \\
        --eval-only MODEL.WEIGHTS model.pth OUTPUT_DIR out
    python -m vnext_tpu_torch.tools.train_net --config-file configs/idol/ytvis19_r50.yaml \\
        [--resume] MODEL.WEIGHTS "" OUTPUT_DIR out

``--eval-only`` runs ``IDOLVideoInference`` on every video of each
``DATASETS.TEST`` dataset and scores them with the YTVIS evaluator
(``results.json`` and the tube-IoU AP dict); without it the clip loader feeds
``VISTrainer`` with its hooks and periodic checkpoints, and ``--resume``
continues from the output directory's ``last_checkpoint``.

IDOL's COCO-pretrain stage (``configs/idol/coco_pretrain/*.yaml``) trains with
``INPUT.COCO_PRETRAIN True``: the COCO splits are registered (and the
synthetic COCO set where the config names it) and ``CocoClipDatasetMapper``
turns each still image into a key + reference pseudo-clip. The yaml files do
not set the flag, and it is not inferred from the dataset's name, as in the
JAX package. Its ``MODEL.WEIGHTS`` may be a detectron2 ``.pkl`` ImageNet init,
opened as a path (a ``detectron2://`` URL is not resolved).

A ``GeneralizedRCNN`` config (Mask R-CNN, Faster R-CNN, keypoint R-CNN with
``MODEL.KEYPOINT_ON``, Cascade R-CNN with ``ROI_HEADS.NAME CascadeROIHeads``),
a ``RetinaNet`` or an ``FCOS`` one runs ``--eval-only`` through
``engine/detection.do_eval_detection``: each image of the COCO-type
``DATASETS.TEST`` sets (the COCO splits and the synthetic COCO set are
registered) is served at ``TPU.TEST_IMAGE_SIZE`` and scored by the COCO
evaluator's box, mask and keypoint AP. Without it,
``engine/detection.do_train_detection`` trains it (and a ``ProposalNetwork``)
on ``DATASETS.TRAIN`` at ``TPU.TRAIN_IMAGE_SIZE``, ``SOLVER.IMS_PER_BATCH``
images a step:

    python -m vnext_tpu_torch.tools.train_net \\
        --config-file configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml [--eval-only | --resume]
    python -m vnext_tpu_torch.tools.train_net --config-file configs/COCO-Detection/retinanet_R_50_FPN_1x.yaml
    python -m vnext_tpu_torch.tools.train_net --config-file configs/Misc/cascade_rcnn_R_50_FPN_1x.yaml
    python -m vnext_tpu_torch.tools.train_net --config-file configs/COCO-Detection/Base-RCNN-FPN.yaml \\
        MODEL.KEYPOINT_ON True

PanopticFPN and SemanticSegmentor raise naming their ROADMAP item (Queue 1,
item 11d).

The run is on the card unless the config says ``MODEL.DEVICE cpu`` (the
tests' setting, which runs the kernels' plain versions); with no CUDA device
visible it raises rather than carry on on the CPU. The defaults' ``"tpu"``, the
JAX package's value, means the card here.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from ..checkpoint.checkpointer import Checkpointer, load_weights
from ..config import add_idol_config, get_cfg
from ..data import (CocoClipDatasetMapper, MetadataCatalog, build_vis_test_loader, build_vis_train_loader,
                    register_all_coco, register_all_ytvis)
from ..data.datasets.synthetic import register_synthetic_coco, register_synthetic_ytvis
from ..engine.hooks import EvalHook, IterationTimer, LRTracker, PeriodicCheckpointer, PeriodicWriter
from ..engine.detection import _ARCH as IMAGE_ARCHITECTURES
from ..engine.detection import do_eval_detection, do_train_detection
from ..engine.launch import launch
from ..engine.train_step import TrainState, make_train_step
from ..engine.trainer import VISTrainer
from ..engine.vis_inference import IDOLVideoInference
from ..evaluation.testing import verify_final_loss, verify_results
from ..evaluation.ytvis_eval import build_evaluator
from ..models.criterion import default_weight_dict
from ..models.idol import build_idol_model
from ..solver.build import build_grad_clip, build_lr_schedule, build_lr_scheduler, build_optimizer
from ..utils.events import CommonMetricPrinter, JSONWriter
from ..utils.logger import setup_logger

# the quick-schedule configs' dataset (configs/quick_schedules/idol_instant_test.yaml)
SYNTHETIC_DATASET = "ytvis_synthetic_tiny"
# the COCO-format synthetic dataset, for the COCO-pretrain stage on the quick-schedule config
SYNTHETIC_COCO_DATASET = "coco_synthetic_tiny"


def default_argument_parser():
    parser = argparse.ArgumentParser(description="vnext_tpu_torch training")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--num-gpus", type=int, default=0, help="0 or 1: the port runs on one card")
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, help="not ported: one process (ROADMAP Queue 1, item 12)")
    parser.add_argument("--dist-url", help="not ported: one process (ROADMAP Queue 1, item 12)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def setup(args, add_config=add_idol_config):
    """The frozen config (``add_config``'s keys, the file, the KEY VALUE
    overrides); creates ``OUTPUT_DIR`` with the log and the config's dump in it."""
    cfg = get_cfg()
    add_config(cfg)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    setup_logger(cfg.OUTPUT_DIR)
    with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
        f.write(cfg.dump())
    return cfg


def resolve_device(cfg) -> torch.device:
    """``MODEL.DEVICE`` "cpu" -> the CPU; "cuda[:i]" or the defaults' "tpu" -> the
    card, which must be visible."""
    name = cfg.MODEL.DEVICE
    if name == "cpu":
        return torch.device("cpu")
    if name != "tpu" and not name.startswith("cuda"):
        raise ValueError(f"MODEL.DEVICE {name!r}: the port runs on 'cuda' (or 'tpu', read as 'cuda') or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"MODEL.DEVICE {name!r}: no CUDA device is visible; the entry point does not "
                           "fall back to the CPU (pass MODEL.DEVICE cpu to run there)")
    return torch.device("cuda" if name == "tpu" else name)


def _register_datasets(cfg):
    """The builtin YTVIS splits, the COCO ones with ``INPUT.COCO_PRETRAIN``, and
    the synthetic datasets (generated under the repository's build directory
    unless registered already) where the config names them."""
    register_all_ytvis()
    named = (*cfg.DATASETS.TRAIN, *cfg.DATASETS.TEST)
    if SYNTHETIC_DATASET in named:
        register_synthetic_ytvis(SYNTHETIC_DATASET)
    if cfg.INPUT.COCO_PRETRAIN:
        register_all_coco()
        if SYNTHETIC_COCO_DATASET in named:
            register_synthetic_coco(SYNTHETIC_COCO_DATASET)


def _check_test_sets(cfg):
    """Raise before the first step what the evaluation after training would
    raise after the last: a ``DATASETS.TEST`` dataset that is not of the
    ``ytvis`` type (IDOL's video path cannot score a COCO set), or one with
    fewer categories than ``MODEL.IDOL.NUM_CLASSES`` (a predicted label past
    the dataset's has no category id to be written under)."""
    for name in cfg.DATASETS.TEST:
        evaluator_type = MetadataCatalog.get(name).get("evaluator_type", "ytvis")
        if evaluator_type != "ytvis":
            raise NotImplementedError(f"DATASETS.TEST {name!r}: IDOL has no evaluator for type {evaluator_type!r}; "
                                      "its video path scores YTVIS-type datasets only")
        build_evaluator(cfg, name)
        classes = MetadataCatalog.get(name).get("thing_classes")
        if classes is not None and len(classes) < cfg.MODEL.IDOL.NUM_CLASSES:
            raise ValueError(f"DATASETS.TEST {name!r} has {len(classes)} categories and the model predicts "
                             f"MODEL.IDOL.NUM_CLASSES {cfg.MODEL.IDOL.NUM_CLASSES}: evaluate on a dataset with as "
                             "many categories, or set DATASETS.TEST \"()\"")


def do_eval(cfg, model=None):
    """{dataset: the evaluator's results} for each ``DATASETS.TEST`` dataset.
    ``model`` (an IDOL, in either mode) is evaluated in eval mode and put back
    in its mode after; without it one is built from ``cfg`` with seeded
    weights, then ``MODEL.WEIGHTS`` loaded if set."""
    _register_datasets(cfg)
    if model is None:
        model = build_idol_model(cfg, device=resolve_device(cfg), seed=0)
        if cfg.MODEL.WEIGHTS:
            load_weights(cfg.MODEL.WEIGHTS, model)
    was_training = model.training
    model.eval()  # the inference path: K1 fused on the card, not K4
    try:
        results = {}
        for dataset_name in cfg.DATASETS.TEST:
            runner = IDOLVideoInference.from_config(cfg, model)
            evaluator = build_evaluator(cfg, dataset_name)
            evaluator.reset()
            for record in build_vis_test_loader(cfg, dataset_name):
                evaluator.process([record], [runner(record)])
            results[dataset_name] = evaluator.evaluate()
    finally:
        model.train(was_training)
    return results


def do_train(cfg, resume: bool = False) -> VISTrainer:
    """Train IDOL for ``SOLVER.MAX_ITER`` steps with the recipe's optimizer,
    schedule and clip, the hooks (timer, learning rate, periodic checkpoints,
    evaluation, metric writers), from the last checkpoint with ``resume``; on
    COCO pseudo-clips with ``INPUT.COCO_PRETRAIN``. A ``DATASETS.TEST`` set
    that the evaluation after training could not score raises first."""
    _register_datasets(cfg)
    _check_test_sets(cfg)
    device = resolve_device(cfg)
    seed = max(cfg.SEED, 0)
    model = build_idol_model(cfg, device=device, seed=seed)
    optimizer = build_optimizer(cfg, model)
    c = cfg.MODEL.IDOL
    weight_dict = default_weight_dict(
        class_weight=c.CLASS_WEIGHT, l1_weight=c.L1_WEIGHT, giou_weight=c.GIOU_WEIGHT,
        mask_weight=c.MASK_WEIGHT, dice_weight=c.DICE_WEIGHT, reid_weight=c.REID_WEIGHT,
        dec_layers=c.DEC_LAYERS, deep_supervision=c.DEEP_SUPERVISION,
    )
    train_step = make_train_step(model, optimizer, weight_dict, build_grad_clip(cfg), seed=seed)
    checkpointer = Checkpointer(cfg.OUTPUT_DIR)
    state = TrainState.create(model, optimizer, build_lr_scheduler(cfg, optimizer))
    state, start_iter = checkpointer.resume_or_load(cfg.MODEL.WEIGHTS, state, resume=resume)

    mapper = CocoClipDatasetMapper.from_config(cfg, is_train=True) if cfg.INPUT.COCO_PRETRAIN else None
    loader = build_vis_train_loader(cfg, mapper=mapper, seed=seed)
    trainer = VISTrainer(train_step, state, loader, device,
                         pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN), pixel_std=tuple(cfg.MODEL.PIXEL_STD))
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


def run(argv, setup, archs, elsewhere: str, do_eval, do_train):
    """An entry point's command line: parse ``argv`` (default ``sys.argv[1:]``),
    make the config with ``setup(args)`` and run ``do_eval(cfg)`` with
    ``--eval-only`` (its first dataset's results held to
    ``TEST.EXPECTED_RESULTS``) or else ``do_train(cfg, resume=)``. Returns the
    eval results or the trainer. A ``MODEL.META_ARCHITECTURE`` not in
    ``archs`` raises, saying where it runs (``elsewhere``)."""
    args = default_argument_parser().parse_args(argv)
    if args.machine_rank is not None or args.dist_url is not None:
        raise NotImplementedError("--machine-rank and --dist-url: the port runs one process on one card until "
                                  "its distribution is ported (ROADMAP Queue 1, item 12)")

    def main_func():
        cfg = setup(args)
        if cfg.MODEL.META_ARCHITECTURE not in archs:
            raise NotImplementedError(f"MODEL.META_ARCHITECTURE {cfg.MODEL.META_ARCHITECTURE!r}: this entry "
                                      f"point runs {', '.join(archs)}; {elsewhere}")
        if args.eval_only:
            results = do_eval(cfg)
            if cfg.TEST.EXPECTED_RESULTS and results:
                verify_results(cfg, next(iter(results.values())) or {})
            print(results)
            return results
        return do_train(cfg, resume=args.resume)

    return launch(main_func, args.num_gpus, num_machines=args.num_machines)


def _register_image_datasets(cfg):
    """The builtin COCO splits, and the synthetic COCO set where the config names it."""
    register_all_coco()
    if SYNTHETIC_COCO_DATASET in (*cfg.DATASETS.TRAIN, *cfg.DATASETS.TEST):
        register_synthetic_coco(SYNTHETIC_COCO_DATASET)


def _eval(cfg):
    """IDOL's ``do_eval``, or an image meta-architecture's ``do_eval_detection``."""
    if cfg.MODEL.META_ARCHITECTURE in IMAGE_ARCHITECTURES:
        _register_image_datasets(cfg)
        return do_eval_detection(cfg, device=resolve_device(cfg))
    return do_eval(cfg)


def _train(cfg, resume: bool = False):
    """IDOL's ``do_train``, or an image meta-architecture's ``do_train_detection``."""
    if cfg.MODEL.META_ARCHITECTURE in IMAGE_ARCHITECTURES:
        _register_image_datasets(cfg)
        return do_train_detection(cfg, resume=resume, device=resolve_device(cfg))
    return do_train(cfg, resume=resume)


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``) and run IDOL or an image
    meta-architecture; returns the eval results with ``--eval-only``, else the
    trainer."""
    return run(argv, setup, ("IDOL", *IMAGE_ARCHITECTURES),
               "MinVIS's MaskFormer runs through vnext_tpu_torch.tools.train_net_video, and SeqFormer has no "
               "entry point in either package", _eval, _train)


if __name__ == "__main__":
    main(sys.argv[1:])
