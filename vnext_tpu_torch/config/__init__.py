"""The port's config reader: ``get_cfg()`` and the project extenders, copies of
``vnext_tpu.config``'s that import neither jax nor the JAX package.

    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file("configs/idol/ytvis19_swinL.yaml")
    model = build_idol_model(cfg)
"""

from .cfgnode import CN, CfgNode
from .configurable import auto_scale_workers, configurable
from .defaults import get_cfg
from .extensions import add_idol_config, add_maskformer_config, add_seqformer_config
from .lazy import LazyCall, LazyConfig, instantiate

__all__ = ["CfgNode", "CN", "configurable", "auto_scale_workers", "get_cfg", "add_idol_config",
           "add_maskformer_config", "add_seqformer_config", "LazyCall", "LazyConfig", "instantiate"]
