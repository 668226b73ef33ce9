"""The YouTube-VIS data layer: catalogs, datasets, clip augmentation, the mapper
and the loaders (counterpart of ``vnext_tpu.data`` for IDOL's entry point)."""

from . import transforms
from .build import (
    InferenceSampler,
    PrefetchIterator,
    TrainingSampler,
    build_vis_test_loader,
    build_vis_train_loader,
)
from .catalog import DatasetCatalog, Metadata, MetadataCatalog
from .dataset_mapper import YTVISDatasetMapper
from .datasets.synthetic import register_synthetic_ytvis
from .datasets.ytvis import (
    OVIS_CLASSES,
    YTVIS_2019_CLASSES,
    YTVIS_2021_CLASSES,
    load_ytvis_json,
    register_all_ytvis,
    register_ytvis_instances,
)

__all__ = [
    "transforms",
    "DatasetCatalog",
    "Metadata",
    "MetadataCatalog",
    "InferenceSampler",
    "PrefetchIterator",
    "TrainingSampler",
    "build_vis_test_loader",
    "build_vis_train_loader",
    "YTVISDatasetMapper",
    "register_synthetic_ytvis",
    "OVIS_CLASSES",
    "YTVIS_2019_CLASSES",
    "YTVIS_2021_CLASSES",
    "load_ytvis_json",
    "register_all_ytvis",
    "register_ytvis_instances",
]
