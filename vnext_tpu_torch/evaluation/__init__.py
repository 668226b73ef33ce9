"""The port's evaluators (``vnext_tpu.evaluation``'s surface): the video AP,
COCO's box / mask / keypoint AP, the rotated boxes' AP, LVIS's AP with its
frequency bands, Pascal VOC's AP50, Cityscapes' instance AP and mIoU,
panoptic quality and semantic segmentation, the combiner, the loop and
``build_evaluator``."""

from .cityscapes_eval import CityscapesInstanceEvaluator, CityscapesSemSegEvaluator
from .coco_eval import COCOEvaluator
from .evaluator import DatasetEvaluators, inference_on_dataset
from .lvis_eval import LVISEvaluator
from .panoptic_eval import COCOPanopticEvaluator, pq_single_image
from .pascal_voc_eval import PascalVOCDetectionEvaluator, voc_ap
from .rotated_coco_eval import RotatedCOCOEvaluator
from .sem_seg_eval import SemSegEvaluator
from .ytvis_eval import DatasetEvaluator, YTVISEvaluator, build_evaluator

__all__ = ["CityscapesInstanceEvaluator", "CityscapesSemSegEvaluator", "COCOEvaluator", "COCOPanopticEvaluator",
           "DatasetEvaluator", "DatasetEvaluators", "LVISEvaluator", "PascalVOCDetectionEvaluator",
           "RotatedCOCOEvaluator", "SemSegEvaluator", "YTVISEvaluator", "build_evaluator", "inference_on_dataset", "pq_single_image",
           "voc_ap"]
