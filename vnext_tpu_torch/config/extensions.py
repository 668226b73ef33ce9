"""Project config extenders: the port's copy of ``vnext_tpu.config.extensions``
(reference surface: projects/IDOL/idol/config.py:5 add_idol_config,
projects/SeqFormer/seqformer/config.py add_seqformer_config).

Key names match the reference so its yaml configs parse unchanged.
"""

from .cfgnode import CfgNode as CN


def add_idol_config(cfg: CN) -> None:
    cfg.MODEL.IDOL = CN()
    cfg.MODEL.IDOL.NUM_CLASSES = 80

    cfg.INPUT.SAMPLING_FRAME_NUM = 2
    cfg.INPUT.SAMPLING_FRAME_RANGE = 10
    cfg.INPUT.SAMPLING_INTERVAL = 1
    cfg.INPUT.SAMPLING_FRAME_SHUFFLE = False
    cfg.INPUT.AUGMENTATIONS = []
    cfg.INPUT.COCO_PRETRAIN = False
    cfg.INPUT.PRETRAIN_SAME_CROP = False

    cfg.MODEL.IDOL.MASK_WEIGHT = 2.0
    cfg.MODEL.IDOL.DICE_WEIGHT = 5.0
    cfg.MODEL.IDOL.GIOU_WEIGHT = 2.0
    cfg.MODEL.IDOL.L1_WEIGHT = 5.0
    cfg.MODEL.IDOL.CLASS_WEIGHT = 2.0
    cfg.MODEL.IDOL.REID_WEIGHT = 2.0
    cfg.MODEL.IDOL.DEEP_SUPERVISION = True
    cfg.MODEL.IDOL.MASK_STRIDE = 4
    cfg.MODEL.IDOL.MATCH_STRIDE = 4
    cfg.MODEL.IDOL.FOCAL_ALPHA = 0.25

    cfg.MODEL.IDOL.SET_COST_CLASS = 2
    cfg.MODEL.IDOL.SET_COST_BOX = 5
    cfg.MODEL.IDOL.SET_COST_GIOU = 2

    cfg.MODEL.IDOL.NHEADS = 8
    cfg.MODEL.IDOL.DROPOUT = 0.1
    cfg.MODEL.IDOL.DIM_FEEDFORWARD = 1024
    cfg.MODEL.IDOL.ENC_LAYERS = 6
    cfg.MODEL.IDOL.DEC_LAYERS = 6
    cfg.MODEL.IDOL.HIDDEN_DIM = 256
    cfg.MODEL.IDOL.NUM_OBJECT_QUERIES = 300
    cfg.MODEL.IDOL.DEC_N_POINTS = 4
    cfg.MODEL.IDOL.ENC_N_POINTS = 4
    cfg.MODEL.IDOL.NUM_FEATURE_LEVELS = 4

    # inference
    cfg.MODEL.IDOL.CLIP_STRIDE = 1
    cfg.MODEL.IDOL.MERGE_ON_CPU = True
    cfg.MODEL.IDOL.MULTI_CLS_ON = True
    cfg.MODEL.IDOL.APPLY_CLS_THRES = 0.05
    cfg.MODEL.IDOL.TEMPORAL_SCORE_TYPE = "mean"
    cfg.MODEL.IDOL.INFERENCE_SELECT_THRES = 0.1
    cfg.MODEL.IDOL.NMS_PRE = 0.5
    cfg.MODEL.IDOL.ADD_NEW_SCORE = 0.2
    cfg.MODEL.IDOL.INFERENCE_FW = True
    cfg.MODEL.IDOL.INFERENCE_TW = True
    cfg.MODEL.IDOL.MEMORY_LEN = 3
    cfg.MODEL.IDOL.BATCH_INFER_LEN = 10

    _add_swin_config(cfg)
    cfg.FIND_UNUSED_PARAMETERS = True  # accepted for parity


def add_seqformer_config(cfg: CN) -> None:
    cfg.MODEL.SeqFormer = CN()
    cfg.MODEL.SeqFormer.NUM_CLASSES = 40

    cfg.INPUT.SAMPLING_FRAME_NUM = 5
    cfg.INPUT.SAMPLING_FRAME_RANGE = 10
    cfg.INPUT.SAMPLING_INTERVAL = 1
    cfg.INPUT.SAMPLING_FRAME_SHUFFLE = False
    cfg.INPUT.AUGMENTATIONS = []
    cfg.INPUT.COCO_PRETRAIN = False
    cfg.INPUT.PRETRAIN_SAME_CROP = False

    cfg.MODEL.SeqFormer.MASK_WEIGHT = 2.0
    cfg.MODEL.SeqFormer.DICE_WEIGHT = 5.0
    cfg.MODEL.SeqFormer.GIOU_WEIGHT = 2.0
    cfg.MODEL.SeqFormer.L1_WEIGHT = 5.0
    cfg.MODEL.SeqFormer.CLASS_WEIGHT = 2.0
    cfg.MODEL.SeqFormer.DEEP_SUPERVISION = True
    cfg.MODEL.SeqFormer.MASK_STRIDE = 4
    cfg.MODEL.SeqFormer.MATCH_STRIDE = 4
    cfg.MODEL.SeqFormer.FOCAL_ALPHA = 0.25

    cfg.MODEL.SeqFormer.SET_COST_CLASS = 2
    cfg.MODEL.SeqFormer.SET_COST_BOX = 5
    cfg.MODEL.SeqFormer.SET_COST_GIOU = 2

    cfg.MODEL.SeqFormer.NHEADS = 8
    cfg.MODEL.SeqFormer.DROPOUT = 0.1
    cfg.MODEL.SeqFormer.DIM_FEEDFORWARD = 1024
    cfg.MODEL.SeqFormer.ENC_LAYERS = 6
    cfg.MODEL.SeqFormer.DEC_LAYERS = 6
    cfg.MODEL.SeqFormer.HIDDEN_DIM = 256
    cfg.MODEL.SeqFormer.NUM_OBJECT_QUERIES = 300
    cfg.MODEL.SeqFormer.DEC_N_POINTS = 4
    cfg.MODEL.SeqFormer.ENC_N_POINTS = 4
    cfg.MODEL.SeqFormer.NUM_FEATURE_LEVELS = 4

    cfg.MODEL.SeqFormer.CLIP_MATCHING = False
    cfg.MODEL.SeqFormer.CLIP_LENGTH = 5
    cfg.MODEL.SeqFormer.CLIP_STRIDE = 1
    cfg.MODEL.SeqFormer.MERGE_ON_CPU = True
    cfg.MODEL.SeqFormer.MULTI_CLS_ON = True
    cfg.MODEL.SeqFormer.APPLY_CLS_THRES = 0.05
    cfg.MODEL.SeqFormer.TEMPORAL_SCORE_TYPE = "mean"

    _add_swin_config(cfg)
    cfg.FIND_UNUSED_PARAMETERS = True


def _add_swin_config(cfg: CN) -> None:
    if "PRETRAIN_IMG_SIZE" in cfg.MODEL.SWIN:
        return
    cfg.MODEL.SWIN.PRETRAIN_IMG_SIZE = 224
    cfg.MODEL.SWIN.PATCH_SIZE = 4
    cfg.MODEL.SWIN.EMBED_DIM = 96
    cfg.MODEL.SWIN.DEPTHS = [2, 2, 6, 2]
    cfg.MODEL.SWIN.NUM_HEADS = [3, 6, 12, 24]
    cfg.MODEL.SWIN.WINDOW_SIZE = 7
    cfg.MODEL.SWIN.MLP_RATIO = 4.0
    cfg.MODEL.SWIN.QKV_BIAS = True
    cfg.MODEL.SWIN.QK_SCALE = None
    cfg.MODEL.SWIN.DROP_RATE = 0.0
    cfg.MODEL.SWIN.ATTN_DROP_RATE = 0.0
    cfg.MODEL.SWIN.DROP_PATH_RATE = 0.3
    cfg.MODEL.SWIN.APE = False
    cfg.MODEL.SWIN.PATCH_NORM = True
    cfg.MODEL.SWIN.USE_CHECKPOINT = False


def add_maskformer_config(cfg: CN) -> None:
    """MinVIS/Mask2Former + InstMove keys (reference
    projects/InstMove/MinVIS_motion/minvis/config.py + mask2former/config.py,
    MODEL.MASK_FORMER.* subset actually consumed by the models)."""
    if "SAMPLING_FRAME_NUM" not in cfg.INPUT:
        cfg.INPUT.SAMPLING_FRAME_NUM = 2
        cfg.INPUT.SAMPLING_FRAME_RANGE = 10
        cfg.INPUT.SAMPLING_INTERVAL = 1
        cfg.INPUT.SAMPLING_FRAME_SHUFFLE = False
        cfg.INPUT.AUGMENTATIONS = []
        cfg.INPUT.COCO_PRETRAIN = False
        cfg.INPUT.PRETRAIN_SAME_CROP = False

    cfg.MODEL.MASK_FORMER = CN()
    cfg.MODEL.MASK_FORMER.NUM_CLASSES = 40
    cfg.MODEL.MASK_FORMER.HIDDEN_DIM = 256
    cfg.MODEL.MASK_FORMER.NUM_OBJECT_QUERIES = 100
    cfg.MODEL.MASK_FORMER.NHEADS = 8
    cfg.MODEL.MASK_FORMER.DIM_FEEDFORWARD = 2048
    cfg.MODEL.MASK_FORMER.ENC_LAYERS = 6       # pixel-decoder MSDA layers
    cfg.MODEL.MASK_FORMER.DEC_LAYERS = 9       # masked-attention decoder layers
    cfg.MODEL.MASK_FORMER.NO_OBJECT_WEIGHT = 0.1
    cfg.MODEL.MASK_FORMER.CLASS_WEIGHT = 2.0
    cfg.MODEL.MASK_FORMER.MASK_WEIGHT = 5.0
    cfg.MODEL.MASK_FORMER.DICE_WEIGHT = 5.0
    cfg.MODEL.MASK_FORMER.DEEP_SUPERVISION = True
    cfg.MODEL.MASK_FORMER.TRAIN_NUM_POINTS = 112 * 112
    cfg.MODEL.MASK_FORMER.SIZE_DIVISIBILITY = 32
    cfg.MODEL.MASK_FORMER.TEST = CN()
    cfg.MODEL.MASK_FORMER.TEST.WINDOW_INFERENCE = True
    cfg.MODEL.MASK_FORMER.TEST.WINDOW_SIZE = 3
    cfg.MODEL.MASK_FORMER.TEST.OBJECT_MASK_THRESHOLD = 0.8
    cfg.MODEL.MASK_FORMER.TEST.OVERLAP_THRESHOLD = 0.8

    # InstMove motion predictor (reference motion_models/model_withImgR6.py)
    cfg.MODEL.INSTMOVE = CN()
    cfg.MODEL.INSTMOVE.ENABLED = False
    cfg.MODEL.INSTMOVE.MEMORY_SIZE = 100
    cfg.MODEL.INSTMOVE.LSTM_LAYERS = 4
    cfg.MODEL.INSTMOVE.LSTM_CHANNELS = 128
    cfg.MODEL.INSTMOVE.SEQ_LEN = 4             # past masks fed to the predictor
    cfg.MODEL.INSTMOVE.WEIGHTS = ""
    cfg.MODEL.INSTMOVE.MASK_SIZE = [192, 192]  # training crop for mask sequences

    _add_swin_config(cfg)
    cfg.FIND_UNUSED_PARAMETERS = True
