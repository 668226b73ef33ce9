"""Backbone factory shared by IDOL, SeqFormer and MaskFormer.

Counterpart of ``vnext_tpu.models.backbones``: the reference selects its
backbone by ``cfg.MODEL.BACKBONE.NAME`` (detectron2's ``build_backbone``; IDOL's
Swin is registered as "D2SwinTransformer"); here, as in the JAX package, the
switch is a plain constructor. Either backbone reports ``output_channels``,
from which the models size their input projections.
"""

from typing import Sequence, Tuple

from .resnet import ResNet
from .swin import SwinTransformer

# (embed_dim, depths, num_heads, window_size, drop_path_rate), the reference's
# tiny / small / base / large tables (swin.py:608-683)
SWIN_PRESETS = {
    "T": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7, 0.2),
    "S": (96, (2, 2, 18, 2), (3, 6, 12, 24), 7, 0.2),
    "B": (128, (2, 2, 18, 2), (4, 8, 16, 32), 12, 0.3),
    "L": (192, (2, 2, 18, 2), (6, 12, 24, 48), 12, 0.3),
}


def make_backbone(backbone_type: str, *, depth: int = 50, stride_in_1x1: bool = False,
                  out_features: Sequence[str] = ("res3", "res4", "res5"),
                  swin: Tuple = SWIN_PRESETS["L"], dtype):
    """backbone_type: "resnet" | "swin"; ``swin`` is a preset tuple as above."""
    if backbone_type == "swin":
        embed_dim, depths, num_heads, window_size, drop_path = swin
        return SwinTransformer(embed_dim=embed_dim, depths=tuple(depths), num_heads=tuple(num_heads),
                               window_size=window_size, drop_path_rate=drop_path,
                               out_features=tuple(out_features), dtype=dtype)
    if backbone_type != "resnet":
        raise ValueError(f"unknown backbone_type {backbone_type!r}")
    return ResNet(depth, dtype, out_features=tuple(out_features), stride_in_1x1=stride_in_1x1)


def backbone_kwargs_from_cfg(cfg) -> dict:
    """Model-constructor kwargs for the config's backbone, as the JAX package's
    function gives them: a ``MODEL.BACKBONE.NAME`` holding "swin" selects Swin
    from ``MODEL.SWIN``'s EMBED_DIM, DEPTHS, NUM_HEADS, WINDOW_SIZE and
    DROP_PATH_RATE (its other keys are not read: the module's defaults stand,
    ROADMAP Queue 3); any other name the ResNet of ``MODEL.RESNETS.DEPTH``."""
    if "swin" in cfg.MODEL.BACKBONE.NAME.lower():
        s = cfg.MODEL.SWIN
        return {"backbone_type": "swin",
                "swin": (s.EMBED_DIM, tuple(s.DEPTHS), tuple(s.NUM_HEADS), s.WINDOW_SIZE, s.DROP_PATH_RATE)}
    return {"backbone_type": "resnet", "backbone_depth": cfg.MODEL.RESNETS.DEPTH}


def backbone_features(backbone, images, generator=None):
    """The backbone's feature maps; in train mode Swin's drop-path draws from
    ``generator`` (a ResNet draws nothing), as the JAX models pass ``train`` to
    Swin alone."""
    if isinstance(backbone, SwinTransformer):
        return backbone(images, generator)
    return backbone(images)
