"""The port's operations. The modules are imported one by one (each kernel's
wrapper registers its operator when its module is imported); these are the
rotated-box and deformable ones, as ``vnext_tpu.ops`` exports them."""

from .deform_conv import deform_conv2d
from .roi_align_rotated import roi_align_rotated
from .rotated_boxes import nms_rotated_mask, pairwise_iou_rotated

__all__ = ["deform_conv2d", "nms_rotated_mask", "pairwise_iou_rotated", "roi_align_rotated"]
