from .builtin import (
    register_all_builtin,
    register_all_cityscapes,
    register_all_coco_panoptic,
    register_all_lvis,
    register_all_pascal_voc,
)
from .builtin_meta import get_keypoint_metadata
from .cityscapes import load_cityscapes_instances, load_cityscapes_semantic, register_cityscapes
from .coco import load_coco_json, register_all_coco, register_coco_instances
from .coco_panoptic import id2rgb, load_coco_panoptic_json, register_coco_panoptic, rgb2id
from .lvis import load_lvis_json, register_lvis_instances
from .pascal_voc import load_voc_instances, register_pascal_voc
from .synthetic import (
    generate_synthetic_cityscapes,
    generate_synthetic_coco,
    generate_synthetic_lvis,
    generate_synthetic_panoptic,
    generate_synthetic_voc,
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
    "register_all_builtin",
    "register_all_cityscapes",
    "register_all_coco_panoptic",
    "register_all_lvis",
    "register_all_pascal_voc",
    "get_keypoint_metadata",
    "load_cityscapes_instances",
    "load_cityscapes_semantic",
    "register_cityscapes",
    "load_coco_json",
    "register_all_coco",
    "register_coco_instances",
    "id2rgb",
    "load_coco_panoptic_json",
    "register_coco_panoptic",
    "rgb2id",
    "load_lvis_json",
    "register_lvis_instances",
    "load_voc_instances",
    "register_pascal_voc",
    "generate_synthetic_cityscapes",
    "generate_synthetic_coco",
    "generate_synthetic_lvis",
    "generate_synthetic_panoptic",
    "generate_synthetic_voc",
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
