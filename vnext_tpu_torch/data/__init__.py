"""The data layer: catalogs, datasets, transforms and augmentation policies,
the YTVIS and COCO pseudo-clip mappers, the plain-image detection mapper,
the samplers and the loaders, and the builtin splits' registration
(counterpart of ``vnext_tpu.data``)."""

from . import augmentation as augmentations  # the policy API (detectron2's T.* namespace)
from . import transforms
from .augmentation import AugInput, Augmentation, AugmentationList, apply_augmentations, build_idol_augmentation
from .build import (
    AspectRatioGroupedDataset,
    InferenceSampler,
    PrefetchIterator,
    RepeatFactorTrainingSampler,
    TrainingSampler,
    build_vis_test_loader,
    build_vis_train_loader,
)
from .catalog import DatasetCatalog, Metadata, MetadataCatalog
from .coco_clip_mapper import CocoClipDatasetMapper
from .dataset_mapper import YTVISDatasetMapper
from .detection_mapper import DetectionDatasetMapper
from .datasets.builtin import register_all_builtin
from .datasets.coco import load_coco_json, register_all_coco, register_coco_instances
from .datasets.synthetic import register_synthetic_coco, register_synthetic_ytvis
from .datasets.ytvis import (
    OVIS_CLASSES,
    YTVIS_2019_CLASSES,
    YTVIS_2021_CLASSES,
    load_ytvis_json,
    register_all_ytvis,
    register_ytvis_instances,
)

__all__ = [
    "AugInput",
    "Augmentation",
    "AugmentationList",
    "apply_augmentations",
    "augmentations",
    "build_idol_augmentation",
    "transforms",
    "DatasetCatalog",
    "Metadata",
    "MetadataCatalog",
    "AspectRatioGroupedDataset",
    "InferenceSampler",
    "PrefetchIterator",
    "RepeatFactorTrainingSampler",
    "TrainingSampler",
    "build_vis_test_loader",
    "build_vis_train_loader",
    "YTVISDatasetMapper",
    "CocoClipDatasetMapper",
    "DetectionDatasetMapper",
    "register_all_builtin",
    "load_coco_json",
    "register_all_coco",
    "register_coco_instances",
    "register_synthetic_coco",
    "register_synthetic_ytvis",
    "OVIS_CLASSES",
    "YTVIS_2019_CLASSES",
    "YTVIS_2021_CLASSES",
    "load_ytvis_json",
    "register_all_ytvis",
    "register_ytvis_instances",
]
