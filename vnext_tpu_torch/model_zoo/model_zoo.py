"""Model zoo: config-path -> (config, weights) mapping.

The port's counterpart of ``vnext_tpu.model_zoo`` (detectron2/model_zoo/model_zoo.py:12-180:
get_config_file, get_checkpoint_url, get) over the repository's own ``configs/``
yaml files, read by the port's config reader. Weight URLs are the reference's
released checkpoints (their ``.pth`` files import through
``checkpoint/torch_import.py``); they are names only here. The port never
downloads: a checkpoint is found in ``$VNEXT_WEIGHTS`` (default
``~/.vnext/weights``) under the URL's file name, or ``get(..., trained=True)``
raises naming the file and its URL, where the JAX package tries ``urllib``.
"""

from __future__ import annotations

import os
from typing import Optional

_CONFIG_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "configs")

# reference release checkpoints: the actual published URLs from the reference
# model-zoo tables (projects/IDOL/IDOL.md:33-55, projects/InstMove/InstMove.md:24)
_HF_IDOL = "https://huggingface.co/QHL067/VNext_ECCV/resolve/main/IDOL"
_HF_INSTMOVE = "https://huggingface.co/Junfeng5/InstMove/resolve/main"
_WEIGHTS = {
    "idol/ytvis19_r50.yaml": f"{_HF_IDOL}/YTVIS19_R50_502AP.pth",
    "idol/ytvis19_r101.yaml": f"{_HF_IDOL}/YTVIS19_R101_501AP.pth",
    "idol/ytvis19_swinL.yaml": f"{_HF_IDOL}/YTVIS19_SWINL_639AP-003.pth",
    "idol/ytvis21_r50.yaml": f"{_HF_IDOL}/YTVIS21_R50_478AP.pth",
    "idol/ytvis21_r101.yaml": f"{_HF_IDOL}/YTVIS21_R101_485AP.pth",
    "idol/ytvis21_swinL.yaml": f"{_HF_IDOL}/YTVIS21_SwinL_608AP-002.pth",
    "idol/ovis_r50.yaml": f"{_HF_IDOL}/OVIS_R50_294AP.pth",
    "idol/ovis_swinL.yaml": f"{_HF_IDOL}/OVIS_SwinL_414AP.pth",
    # COCO pretrain checkpoints (IDOL.md:23-25)
    "idol/coco_pretrain/r50_coco_sequence.yaml": f"{_HF_IDOL}/cocopretrain_R50.pth",
    "idol/coco_pretrain/swin_coco_sequence.yaml": f"{_HF_IDOL}/cocopretrain_SWINL.pth",
    # SeqFormer zoo is "in preparation" upstream (SeqFormer.md); MinVIS+motion
    # checkpoints from projects/InstMove/InstMove.md:24
    "minvis/ovis_r50.yaml": f"{_HF_INSTMOVE}/minvis_ovis_R50.pth",
    "minvis/ovis_r50_motion.yaml": f"{_HF_INSTMOVE}/minvis_ovis_R50.pth",
}


def get_config_file(config_path: str) -> str:
    path = os.path.join(_CONFIG_ROOT, config_path)
    if not os.path.exists(path):
        raise RuntimeError(f"{config_path} not available in model zoo ({path})")
    return os.path.abspath(path)


def get_checkpoint_url(config_path: str) -> str:
    """The published release URL for this config (reference model-zoo tables)."""
    if config_path not in _WEIGHTS:
        raise RuntimeError(f"No pretrained weights registered for {config_path}")
    return _WEIGHTS[config_path]


def _cache_dir() -> str:
    return os.environ.get(
        "VNEXT_WEIGHTS", os.path.join(os.path.expanduser("~"), ".vnext", "weights")
    )


def resolve_checkpoint(config_path: str) -> Optional[str]:
    """The local path of a zoo checkpoint in the ``$VNEXT_WEIGHTS`` cache, or
    None when it is not there. Nothing is downloaded."""
    local = os.path.join(_cache_dir(), os.path.basename(get_checkpoint_url(config_path)))
    return local if os.path.exists(local) else None


def get_config(config_path: str, trained: bool = False):
    """The zoo entry's config through the port's reader (MaskFormer's keys for
    ``minvis/``, IDOL's and SeqFormer's for the rest); with ``trained``,
    ``MODEL.WEIGHTS`` is the cached file, or else the release URL (which
    ``load_weights`` cannot open: fetch it into ``$VNEXT_WEIGHTS``)."""
    from ..config import add_idol_config, add_maskformer_config, add_seqformer_config, get_cfg

    cfg = get_cfg()
    if config_path.startswith("minvis"):
        add_maskformer_config(cfg)
    else:
        add_idol_config(cfg)
        add_seqformer_config(cfg)
    cfg.merge_from_file(get_config_file(config_path))
    if trained:
        cfg.MODEL.WEIGHTS = resolve_checkpoint(config_path) or get_checkpoint_url(config_path)
    return cfg


def list_configs():
    """All config paths with registered pretrained weights."""
    return sorted(_WEIGHTS)


def get(config_path: str, trained: bool = False, init: bool = True, device="cuda"):
    """(model, cfg) for a zoo config: the model in eval mode on ``device`` (the
    card by default; it raises without one) with seeded weights, and with
    ``trained`` the cached release checkpoint loaded into it. A checkpoint that
    is not cached raises ``FileNotFoundError`` naming the file and its URL.

    ``init=False`` builds the model on the ``meta`` device (shapes, no storage,
    no initialization, ``device`` unused): cheap enough to build every entry."""
    from ..checkpoint.checkpointer import load_weights
    from ..models import build_model

    cfg = get_config(config_path)
    if not init:
        return build_model(cfg, device="meta"), cfg
    local = None
    if trained:
        local = resolve_checkpoint(config_path)
        if local is None:
            name = os.path.basename(get_checkpoint_url(config_path))
            raise FileNotFoundError(
                f"weights for {config_path} are not cached: put {name} (released at "
                f"{get_checkpoint_url(config_path)}) into {_cache_dir()} ($VNEXT_WEIGHTS); "
                "the port does not download")
        cfg.MODEL.WEIGHTS = local
    model = build_model(cfg, device=device)
    if local is not None:
        load_weights(local, model)
    return model, cfg
