from .synthetic import generate_synthetic_ytvis, register_synthetic_ytvis
from .ytvis import (
    OVIS_CLASSES,
    YTVIS_2019_CLASSES,
    YTVIS_2021_CLASSES,
    load_ytvis_json,
    register_all_ytvis,
    register_ytvis_instances,
)

__all__ = [
    "generate_synthetic_ytvis",
    "register_synthetic_ytvis",
    "OVIS_CLASSES",
    "YTVIS_2019_CLASSES",
    "YTVIS_2021_CLASSES",
    "load_ytvis_json",
    "register_all_ytvis",
    "register_ytvis_instances",
]
