"""The port's meta-architectures and ``build_model``.

``build_model(cfg, device)`` dispatches on ``MODEL.META_ARCHITECTURE`` as
``vnext_tpu.models.build_model`` does: ``IDOL``, ``SeqFormer``, and
``MaskFormer`` / ``VideoMaskFormer_frame`` (MinVIS's registry name), and the
first Detectron2 family, ``GeneralizedRCNN`` (Mask R-CNN and Faster R-CNN,
serving only). The other Detectron2 image architectures are not ported yet
(ROADMAP Queue 1, item 11) and raise; a name neither package knows raises the
registry's ``KeyError``.
The entry points keep their own builders; the tools (demo, export, analysis,
model zoo) use this one.
"""

from __future__ import annotations

import torch

from ..utils.registry import Registry
from .idol import IDOL, build_idol_model, idol_kwargs_from_cfg
from .layers import init_weights
from .mask2former import MaskFormer, build_maskformer_model, maskformer_kwargs_from_cfg
from .rcnn import GeneralizedRCNN
from .seqformer import SeqFormer, build_seqformer_model, seqformer_kwargs_from_cfg

META_ARCH_REGISTRY = Registry("META_ARCH")
for _cls in (IDOL, SeqFormer, MaskFormer, GeneralizedRCNN):
    META_ARCH_REGISTRY.register(_cls)


def rcnn_kwargs_from_cfg(cfg) -> dict:
    """GeneralizedRCNN's constructor arguments from a config node: the keys of
    ``vnext_tpu.models._build_rcnn`` that serving reads (the ROI sampler's
    come with training, item 11b). ``proposals_per_image`` comes from
    ``MODEL.RPN.POST_NMS_TOPK_TRAIN`` at test time too, as there; a
    ``CascadeROIHeads`` or ``MODEL.KEYPOINT_ON`` config makes the model raise
    (ROADMAP Queue 1, item 11d)."""
    return dict(
        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES, backbone_depth=cfg.MODEL.RESNETS.DEPTH,
        fpn_channels=cfg.MODEL.FPN.OUT_CHANNELS, proposals_per_image=cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN,
        mask_on=cfg.MODEL.MASK_ON, keypoint_on=cfg.MODEL.KEYPOINT_ON,
        test_score_thresh=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST, test_nms_thresh=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
        max_detections=cfg.TEST.DETECTIONS_PER_IMAGE, cascade_on=cfg.MODEL.ROI_HEADS.NAME == "CascadeROIHeads",
        dtype=torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32,
    )


def build_rcnn_model(cfg, device="cuda", seed: int = 0) -> GeneralizedRCNN:
    """GeneralizedRCNN in eval mode on ``device`` with seeded random weights;
    with no CUDA device visible the card raises (pass ``device="cpu"``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_rcnn_model: no CUDA device is visible; pass device='cpu' "
                           "to run the plain versions on the CPU")
    model = GeneralizedRCNN(**rcnn_kwargs_from_cfg(cfg))
    init_weights(model, seed)
    return model.to(device).eval()


# name -> (the module, its constructor arguments from a config, its seeded builder)
_BUILDERS = {
    "IDOL": (IDOL, idol_kwargs_from_cfg, build_idol_model),
    "SeqFormer": (SeqFormer, seqformer_kwargs_from_cfg, build_seqformer_model),
    "MaskFormer": (MaskFormer, maskformer_kwargs_from_cfg, build_maskformer_model),
    "VideoMaskFormer_frame": (MaskFormer, maskformer_kwargs_from_cfg, build_maskformer_model),
    "GeneralizedRCNN": (GeneralizedRCNN, rcnn_kwargs_from_cfg, build_rcnn_model),
}
# vnext_tpu.models.build_model's image architectures that are not ported yet, each with its ROADMAP item
DETECTRON2_ARCHITECTURES = {"PanopticFPN": "11d", "ProposalNetwork": "11b", "RetinaNet": "11c", "FCOS": "11c",
                            "SemanticSegmentor": "11d"}


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


__all__ = ["META_ARCH_REGISTRY", "DETECTRON2_ARCHITECTURES", "build_model", "build_rcnn_model",
           "rcnn_kwargs_from_cfg"]
