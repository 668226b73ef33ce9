"""The port's config reader: ``get_cfg()`` and the project extenders, copies of
``vnext_tpu.config``'s that import neither jax nor the JAX package.

    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file("configs/idol/ytvis19_swinL.yaml")
    model = build_idol_model(cfg)
"""

from .cfgnode import CN, CfgNode
from .defaults import get_cfg
from .extensions import add_idol_config, add_maskformer_config, add_seqformer_config

__all__ = ["CfgNode", "CN", "get_cfg", "add_idol_config", "add_maskformer_config", "add_seqformer_config"]
