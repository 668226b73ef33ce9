"""The port's meta-architectures and ``build_model``.

``build_model(cfg, device)`` dispatches on ``MODEL.META_ARCHITECTURE`` as
``vnext_tpu.models.build_model`` does: ``IDOL``, ``SeqFormer``, and
``MaskFormer`` / ``VideoMaskFormer_frame`` (MinVIS's registry name). The
Detectron2 image architectures are not ported yet (ROADMAP Queue 1, item 11)
and raise; a name neither package knows raises the registry's ``KeyError``.
The entry points keep their own builders; the tools (demo, export, analysis,
model zoo) use this one.
"""

from __future__ import annotations

import torch

from ..utils.registry import Registry
from .idol import IDOL, build_idol_model, idol_kwargs_from_cfg
from .mask2former import MaskFormer, build_maskformer_model, maskformer_kwargs_from_cfg
from .seqformer import SeqFormer, build_seqformer_model, seqformer_kwargs_from_cfg

META_ARCH_REGISTRY = Registry("META_ARCH")
for _cls in (IDOL, SeqFormer, MaskFormer):
    META_ARCH_REGISTRY.register(_cls)

# name -> (the module, its constructor arguments from a config, its seeded builder)
_BUILDERS = {
    "IDOL": (IDOL, idol_kwargs_from_cfg, build_idol_model),
    "SeqFormer": (SeqFormer, seqformer_kwargs_from_cfg, build_seqformer_model),
    "MaskFormer": (MaskFormer, maskformer_kwargs_from_cfg, build_maskformer_model),
    "VideoMaskFormer_frame": (MaskFormer, maskformer_kwargs_from_cfg, build_maskformer_model),
}
# vnext_tpu.models.build_model's image architectures
DETECTRON2_ARCHITECTURES = ("GeneralizedRCNN", "PanopticFPN", "ProposalNetwork", "RetinaNet", "FCOS",
                            "SemanticSegmentor")


def build_model(cfg, device="cuda", seed: int = 0) -> torch.nn.Module:
    """The configured meta-architecture in eval mode on ``device`` with seeded
    random weights (the JAX package's ``model.init``; load ``MODEL.WEIGHTS``
    after). The card is the default, and without one this raises. On the
    ``meta`` device the module is only shaped, with no storage and no
    initialization: cheap enough to build every model-zoo entry."""
    name = cfg.MODEL.META_ARCHITECTURE
    if name in DETECTRON2_ARCHITECTURES:
        raise NotImplementedError(f"MODEL.META_ARCHITECTURE {name!r}: the Detectron2 families are not ported "
                                  "to vnext_tpu_torch yet (ROADMAP Queue 1, item 11)")
    if name not in _BUILDERS:
        META_ARCH_REGISTRY.get(name)   # raises KeyError, naming what is registered
    cls, kwargs_from_cfg, builder = _BUILDERS[name]
    device = torch.device(device)
    if device.type == "meta":
        with torch.device("meta"):
            return cls(**kwargs_from_cfg(cfg)).eval()
    return builder(cfg, device=device, seed=seed)


__all__ = ["META_ARCH_REGISTRY", "DETECTRON2_ARCHITECTURES", "build_model"]
