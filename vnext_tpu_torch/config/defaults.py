"""Default configuration tree: the port's copy of ``vnext_tpu.config.defaults``.

The subset of the reference's defaults (detectron2/config/defaults.py) that the
repository's yaml files set, with the JAX package's values, so that a file
parses to the same tree through either package. The ``TPU`` node keeps its
name: the port reads ``TPU.COMPUTE_DTYPE``, ``TPU.MAX_INSTANCES``,
``TPU.MSDA_IMPL``, ``TPU.TEST_IMAGE_SIZE`` and ``TPU.FUSED_TRACKER`` from it.
"""

from .cfgnode import CfgNode as CN

_C = CN()

_C.VERSION = 2

_C.MODEL = CN()
_C.MODEL.DEVICE = "tpu"         # the JAX package's value; the port's builders take device=
_C.MODEL.META_ARCHITECTURE = "IDOL"
_C.MODEL.WEIGHTS = ""
_C.MODEL.MASK_ON = True
_C.MODEL.KEYPOINT_ON = False
_C.MODEL.LOAD_PROPOSALS = False
# ImageNet RGB means/stds; the reference defaults are BGR caffe-style but IDOL configs
# override to RGB torchvision values (projects/IDOL/configs/*.yaml)
_C.MODEL.PIXEL_MEAN = [123.675, 116.280, 103.530]
_C.MODEL.PIXEL_STD = [58.395, 57.120, 57.375]

_C.MODEL.BACKBONE = CN()
_C.MODEL.BACKBONE.NAME = "build_resnet_backbone"
_C.MODEL.BACKBONE.FREEZE_AT = 2

_C.MODEL.RESNETS = CN()
_C.MODEL.RESNETS.DEPTH = 50
_C.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
_C.MODEL.RESNETS.NUM_GROUPS = 1
_C.MODEL.RESNETS.NORM = "FrozenBN"
_C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
_C.MODEL.RESNETS.STRIDE_IN_1X1 = False
_C.MODEL.RESNETS.RES5_DILATION = 1
_C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
_C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
_C.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, False, False, False]
_C.MODEL.RESNETS.DEFORM_MODULATED = False
_C.MODEL.RESNETS.DEFORM_NUM_GROUPS = 1

# ---- detection heads (reference defaults.py surface for the core model zoo) ----
_C.MODEL.RPN = CN()
_C.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 2000
_C.MODEL.RPN.PRE_NMS_TOPK_TEST = 1000
_C.MODEL.RPN.POST_NMS_TOPK_TRAIN = 1000
_C.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
_C.MODEL.RPN.NMS_THRESH = 0.7

_C.MODEL.ROI_HEADS = CN()
_C.MODEL.ROI_HEADS.NAME = "StandardROIHeads"
_C.MODEL.ROI_HEADS.NUM_CLASSES = 80
_C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
_C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
_C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
_C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5

_C.MODEL.ROI_KEYPOINT_HEAD = CN()
_C.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 17

_C.MODEL.RETINANET = CN()
_C.MODEL.RETINANET.NUM_CLASSES = 80
_C.MODEL.RETINANET.SCORE_THRESH_TEST = 0.05
_C.MODEL.RETINANET.NMS_THRESH_TEST = 0.5

_C.MODEL.FCOS = CN()
_C.MODEL.FCOS.NUM_CLASSES = 80

_C.MODEL.SEM_SEG_HEAD = CN()
_C.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 54
_C.MODEL.SEM_SEG_HEAD.IGNORE_VALUE = 255
_C.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT = 0.5

_C.MODEL.FPN = CN()
_C.MODEL.FPN.OUT_CHANNELS = 256
_C.MODEL.FPN.NORM = ""  # "", "GN", "SyncBN" (reference fpn.py norm arg)


_C.MODEL.SWIN = CN()
_C.MODEL.SWIN.SIZE = "B"  # T/S/B/L
_C.MODEL.SWIN.USE_CHECKPOINT = False
_C.MODEL.SWIN.OUT_FEATURES = ["stage3", "stage4", "stage5"]

_C.INPUT = CN()
_C.INPUT.MIN_SIZE_TRAIN = (800,)
_C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
_C.INPUT.MAX_SIZE_TRAIN = 1333
_C.INPUT.MIN_SIZE_TEST = 800
_C.INPUT.MAX_SIZE_TEST = 1333
_C.INPUT.RANDOM_FLIP = "horizontal"
_C.INPUT.CROP = CN()
_C.INPUT.CROP.ENABLED = False
_C.INPUT.CROP.TYPE = "relative_range"
_C.INPUT.CROP.SIZE = [0.9, 0.9]
_C.INPUT.FORMAT = "RGB"
_C.INPUT.MASK_FORMAT = "polygon"

_C.DATASETS = CN()
_C.DATASETS.TRAIN = ()
_C.DATASETS.TEST = ()

_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 4
_C.DATALOADER.ASPECT_RATIO_GROUPING = True
_C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
_C.DATALOADER.REPEAT_THRESHOLD = 0.0
_C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

_C.SOLVER = CN()
_C.SOLVER.IMS_PER_BATCH = 16
_C.SOLVER.BASE_LR = 0.0001
_C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
_C.SOLVER.MAX_ITER = 40000
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.NESTEROV = False
_C.SOLVER.WEIGHT_DECAY = 0.0001
_C.SOLVER.WEIGHT_DECAY_NORM = 0.0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (30000,)
_C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
_C.SOLVER.WARMUP_ITERS = 1000
_C.SOLVER.WARMUP_METHOD = "linear"
_C.SOLVER.CHECKPOINT_PERIOD = 5000
_C.SOLVER.REFERENCE_WORLD_SIZE = 0
_C.SOLVER.OPTIMIZER = "ADAMW"
_C.SOLVER.BACKBONE_MULTIPLIER = 0.1
_C.SOLVER.CLIP_GRADIENTS = CN()
_C.SOLVER.CLIP_GRADIENTS.ENABLED = False
_C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "full_model"
_C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 0.01
_C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0
_C.SOLVER.AMP = CN()
_C.SOLVER.AMP.ENABLED = True  # accepted for config compatibility; TPU.COMPUTE_DTYPE sets the dtype

_C.TEST = CN()
_C.TEST.EVAL_PERIOD = 0
_C.TEST.DETECTIONS_PER_IMAGE = 100
_C.TEST.EXPECTED_RESULTS = []
# Quick-schedule guard: if > 0, assert the final recorded total_loss is finite
# and <= this bound after training (makes instant tests able to fail on a
# corrupted model; complements EXPECTED_RESULTS which pins eval metrics).
_C.TEST.FINAL_LOSS_BOUND = 0.0
_C.TEST.AUG = CN()
_C.TEST.AUG.ENABLED = False
_C.TEST.AUG.MIN_SIZES = (400, 500, 600, 700, 800, 900, 1000, 1100, 1200)
_C.TEST.AUG.MAX_SIZE = 4000
_C.TEST.AUG.FLIP = True

_C.OUTPUT_DIR = "./output"
_C.SEED = -1
_C.CUDNN_BENCHMARK = False  # accepted for config compatibility

# ---------------------------------------------------------------------------
# the JAX package's knobs, under its node name
# ---------------------------------------------------------------------------
_C.TPU = CN()
_C.TPU.MESH_SHAPE = [-1]          # data-parallel mesh; -1 = all devices
_C.TPU.MESH_AXIS_NAMES = ["data"]
_C.TPU.COMPUTE_DTYPE = "bfloat16"  # matmul/conv compute dtype
_C.TPU.PARAM_DTYPE = "float32"
_C.TPU.MAX_INSTANCES = 48          # fixed GT capacity per frame (padded)
_C.TPU.IMAGE_SIZE_DIVISIBILITY = 32
_C.TPU.TRAIN_IMAGE_SIZE = [480, 864]  # fixed padded train shape (H, W)
_C.TPU.TEST_IMAGE_SIZE = [480, 864]   # fixed padded eval shape (H, W)
_C.TPU.MSDA_IMPL = "auto"          # 'jnp' | 'xla' | 'pallas' | 'pallas_v7' | 'auto'
_C.TPU.FUSED_TRACKER = False       # run the IDOL tracker on device (fixed caps)
_C.TPU.FUSED_TRACKER_CAPACITY = 32 # tracklet slots for the fused tracker
_C.TPU.FUSED_TRACKER_DETS = 64     # detections/frame cap for the fused tracker
_C.TPU.DONATE_STATE = True


def get_cfg() -> CN:
    """Return a fresh copy of the default config (reference: config/config.py:99)."""
    return _C.clone()
