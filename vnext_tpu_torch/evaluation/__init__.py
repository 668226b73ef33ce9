"""The port's evaluators (``vnext_tpu.evaluation``'s surface for the ported
types): the video AP, COCO's box / mask / keypoint AP, panoptic quality and
semantic segmentation, the combiner, the loop and ``build_evaluator``."""

from .coco_eval import COCOEvaluator
from .evaluator import DatasetEvaluators, inference_on_dataset
from .panoptic_eval import COCOPanopticEvaluator, pq_single_image
from .sem_seg_eval import SemSegEvaluator
from .ytvis_eval import DatasetEvaluator, YTVISEvaluator, build_evaluator

__all__ = ["COCOEvaluator", "COCOPanopticEvaluator", "DatasetEvaluator", "DatasetEvaluators", "SemSegEvaluator",
           "YTVISEvaluator", "build_evaluator", "inference_on_dataset", "pq_single_image"]
