from .builtin_meta import get_keypoint_metadata
from .coco import load_coco_json, register_all_coco, register_coco_instances
from .coco_panoptic import id2rgb, load_coco_panoptic_json, register_coco_panoptic, rgb2id
from .synthetic import (
    generate_synthetic_coco,
    generate_synthetic_panoptic,
    generate_synthetic_ytvis,
    register_synthetic_coco,
    register_synthetic_panoptic,
    register_synthetic_ytvis,
)
from .ytvis import (
    OVIS_CLASSES,
    YTVIS_2019_CLASSES,
    YTVIS_2021_CLASSES,
    load_ytvis_json,
    register_all_ytvis,
    register_ytvis_instances,
)

__all__ = [
    "get_keypoint_metadata",
    "load_coco_json",
    "register_all_coco",
    "register_coco_instances",
    "id2rgb",
    "load_coco_panoptic_json",
    "register_coco_panoptic",
    "rgb2id",
    "generate_synthetic_coco",
    "generate_synthetic_panoptic",
    "generate_synthetic_ytvis",
    "register_synthetic_coco",
    "register_synthetic_panoptic",
    "register_synthetic_ytvis",
    "OVIS_CLASSES",
    "YTVIS_2019_CLASSES",
    "YTVIS_2021_CLASSES",
    "load_ytvis_json",
    "register_all_ytvis",
    "register_ytvis_instances",
]
