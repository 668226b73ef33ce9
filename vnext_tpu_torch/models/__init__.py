"""The port's meta-architectures and ``build_model``.

``build_model(cfg, device)`` dispatches on ``MODEL.META_ARCHITECTURE`` as
``vnext_tpu.models.build_model`` does: ``IDOL``, ``SeqFormer``, and
``MaskFormer`` / ``VideoMaskFormer_frame`` (MinVIS's registry name), and the
Detectron2 families ``GeneralizedRCNN`` (Mask R-CNN, Faster R-CNN, keypoint
R-CNN with ``MODEL.KEYPOINT_ON``, Cascade R-CNN with ``ROI_HEADS.NAME
CascadeROIHeads``), ``ProposalNetwork``, ``RetinaNet`` and ``FCOS``.
PanopticFPN and SemanticSegmentor are not ported yet (ROADMAP Queue 1, item
11d) and raise; a name neither package knows raises the registry's
``KeyError``.
The entry points keep their own builders; the tools (demo, export, analysis,
model zoo) use this one.
"""

from __future__ import annotations

import torch

from ..utils.registry import Registry
from .fcos import FCOS
from .idol import IDOL, build_idol_model, idol_kwargs_from_cfg
from .layers import init_weights
from .mask2former import MaskFormer, build_maskformer_model, maskformer_kwargs_from_cfg
from .rcnn import GeneralizedRCNN, ProposalNetwork
from .retinanet import RetinaNet
from .seqformer import SeqFormer, build_seqformer_model, seqformer_kwargs_from_cfg

META_ARCH_REGISTRY = Registry("META_ARCH")
for _cls in (IDOL, SeqFormer, MaskFormer, GeneralizedRCNN, ProposalNetwork, RetinaNet, FCOS):
    META_ARCH_REGISTRY.register(_cls)


def rcnn_kwargs_from_cfg(cfg) -> dict:
    """GeneralizedRCNN's constructor arguments from a config node: the keys of
    ``vnext_tpu.models._build_rcnn``. ``proposals_per_image`` comes from
    ``MODEL.RPN.POST_NMS_TOPK_TRAIN`` at test time too, as there, and the RPN
    keeps its own pre-NMS top-k (2000 / 1000; ``PRE_NMS_TOPK_*`` are not
    read in either package). ``ROI_HEADS.NAME CascadeROIHeads`` makes the
    cascade's heads, box-only as in JAX; ``MODEL.KEYPOINT_ON`` adds the
    keypoint head of ``ROI_KEYPOINT_HEAD.NUM_KEYPOINTS``."""
    return dict(
        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES, backbone_depth=cfg.MODEL.RESNETS.DEPTH,
        fpn_channels=cfg.MODEL.FPN.OUT_CHANNELS, proposals_per_image=cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN,
        roi_batch_per_image=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        roi_pos_fraction=cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION, mask_on=cfg.MODEL.MASK_ON,
        keypoint_on=cfg.MODEL.KEYPOINT_ON, num_keypoints=cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS,
        test_score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST, test_nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
        max_detections=cfg.TEST.DETECTIONS_PER_IMAGE, cascade_on=cfg.MODEL.ROI_HEADS.NAME == "CascadeROIHeads",
        dtype=torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32,
    )


def proposal_kwargs_from_cfg(cfg) -> dict:
    """ProposalNetwork's constructor arguments (``vnext_tpu.models.build_model``'s
    ``_proposal``): it computes in f32 whatever ``TPU.COMPUTE_DTYPE`` says, as
    there, so the card runs no hand-written kernel for it."""
    return dict(backbone_depth=cfg.MODEL.RESNETS.DEPTH, fpn_channels=cfg.MODEL.FPN.OUT_CHANNELS,
                proposals_per_image=cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN)


def retinanet_kwargs_from_cfg(cfg) -> dict:
    """RetinaNet's constructor arguments (``vnext_tpu.models.build_model``'s
    ``_retinanet``): ``MODEL.RETINANET.NUM_CLASSES`` and the ResNet depth; the
    rest are the model's defaults (FPN 256, 3 anchors a location, top 1000,
    NMS 0.5, 100 detections). It computes in f32 whatever ``TPU.COMPUTE_DTYPE``
    says, as there, so the card runs no hand-written kernel for it."""
    return dict(num_classes=cfg.MODEL.RETINANET.NUM_CLASSES, backbone_depth=cfg.MODEL.RESNETS.DEPTH)


def fcos_kwargs_from_cfg(cfg) -> dict:
    """FCOS's constructor arguments (``_fcos`` there): ``MODEL.FCOS.NUM_CLASSES``
    and the ResNet depth; in f32 whatever ``TPU.COMPUTE_DTYPE`` says, as
    RetinaNet."""
    return dict(num_classes=cfg.MODEL.FCOS.NUM_CLASSES, backbone_depth=cfg.MODEL.RESNETS.DEPTH)


def _seeded(cls, kwargs: dict, device, seed: int, what: str) -> torch.nn.Module:
    """``cls(**kwargs)`` in eval mode on ``device`` with seeded random weights;
    with no CUDA device visible the card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device is visible; pass device='cpu' "
                           "to run the plain versions on the CPU")
    model = cls(**kwargs)
    init_weights(model, seed)
    return model.to(device).eval()


def build_rcnn_model(cfg, device="cuda", seed: int = 0) -> GeneralizedRCNN:
    """GeneralizedRCNN in eval mode on ``device`` with seeded random weights
    (pass ``device="cpu"`` without a card)."""
    return _seeded(GeneralizedRCNN, rcnn_kwargs_from_cfg(cfg), device, seed, "build_rcnn_model")


def build_proposal_model(cfg, device="cuda", seed: int = 0) -> ProposalNetwork:
    """ProposalNetwork as ``build_rcnn_model`` builds GeneralizedRCNN."""
    return _seeded(ProposalNetwork, proposal_kwargs_from_cfg(cfg), device, seed, "build_proposal_model")


def build_retinanet_model(cfg, device="cuda", seed: int = 0) -> RetinaNet:
    """RetinaNet as ``build_rcnn_model`` builds GeneralizedRCNN."""
    return _seeded(RetinaNet, retinanet_kwargs_from_cfg(cfg), device, seed, "build_retinanet_model")


def build_fcos_model(cfg, device="cuda", seed: int = 0) -> FCOS:
    """FCOS as ``build_rcnn_model`` builds GeneralizedRCNN."""
    return _seeded(FCOS, fcos_kwargs_from_cfg(cfg), device, seed, "build_fcos_model")


# name -> (the module, its constructor arguments from a config, its seeded builder)
_BUILDERS = {
    "IDOL": (IDOL, idol_kwargs_from_cfg, build_idol_model),
    "SeqFormer": (SeqFormer, seqformer_kwargs_from_cfg, build_seqformer_model),
    "MaskFormer": (MaskFormer, maskformer_kwargs_from_cfg, build_maskformer_model),
    "VideoMaskFormer_frame": (MaskFormer, maskformer_kwargs_from_cfg, build_maskformer_model),
    "GeneralizedRCNN": (GeneralizedRCNN, rcnn_kwargs_from_cfg, build_rcnn_model),
    "ProposalNetwork": (ProposalNetwork, proposal_kwargs_from_cfg, build_proposal_model),
    "RetinaNet": (RetinaNet, retinanet_kwargs_from_cfg, build_retinanet_model),
    "FCOS": (FCOS, fcos_kwargs_from_cfg, build_fcos_model),
}
# vnext_tpu.models.build_model's image architectures that are not ported yet, each with its ROADMAP item
DETECTRON2_ARCHITECTURES = {"PanopticFPN": "11d", "SemanticSegmentor": "11d"}


def build_model(cfg, device="cuda", seed: int = 0) -> torch.nn.Module:
    """The configured meta-architecture in eval mode on ``device`` with seeded
    random weights (the JAX package's ``model.init``; load ``MODEL.WEIGHTS``
    after). The card is the default, and without one this raises. On the
    ``meta`` device the module is only shaped, with no storage and no
    initialization: cheap enough to build every model-zoo entry."""
    name = cfg.MODEL.META_ARCHITECTURE
    if name in DETECTRON2_ARCHITECTURES:
        raise NotImplementedError(f"MODEL.META_ARCHITECTURE {name!r}: this Detectron2 architecture is not ported "
                                  f"to vnext_tpu_torch yet (ROADMAP Queue 1, item {DETECTRON2_ARCHITECTURES[name]})")
    if name not in _BUILDERS:
        META_ARCH_REGISTRY.get(name)   # raises KeyError, naming what is registered
    cls, kwargs_from_cfg, builder = _BUILDERS[name]
    device = torch.device(device)
    if device.type == "meta":
        with torch.device("meta"):
            return cls(**kwargs_from_cfg(cfg)).eval()
    return builder(cfg, device=device, seed=seed)


__all__ = ["META_ARCH_REGISTRY", "DETECTRON2_ARCHITECTURES", "build_fcos_model", "build_model", "build_proposal_model",
           "build_rcnn_model", "build_retinanet_model", "fcos_kwargs_from_cfg", "proposal_kwargs_from_cfg",
           "rcnn_kwargs_from_cfg", "retinanet_kwargs_from_cfg"]
