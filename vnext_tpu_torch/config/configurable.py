"""@configurable dual cfg/kwargs constructors + the linear-scaling-rule config
rescale (capability parity with detectron2/config/config.py:130 configurable
and engine/defaults.py:632 DefaultTrainer.auto_scale_workers); the port's copy
of ``vnext_tpu.config.configurable`` on its own ``CfgNode``."""

from __future__ import annotations

import functools
import inspect

from .cfgnode import CfgNode


def configurable(init_func=None, *, from_config=None):
    """Make a class's ``__init__`` (or a function) callable either with explicit
    keyword arguments or with a CfgNode first argument that is translated by a
    ``from_config`` classmethod / function.

    Class usage::

        class Thing:
            @configurable
            def __init__(self, a, b=1): ...
            @classmethod
            def from_config(cls, cfg):
                return {"a": cfg.A, "b": cfg.B}

        Thing(cfg)            # goes through from_config
        Thing(a=3, b=4)       # direct

    Function usage::

        @configurable(from_config=lambda cfg: {"a": cfg.A})
        def build_thing(a): ...
    """
    if init_func is not None:
        if not (inspect.isfunction(init_func) and from_config is None and init_func.__name__ == "__init__"):
            raise TypeError("@configurable without arguments only decorates __init__")

        @functools.wraps(init_func)
        def wrapped(self, *args, **kwargs):
            from_cfg = getattr(type(self), "from_config", None)
            if _called_with_cfg(*args, **kwargs):
                if from_cfg is None:
                    raise TypeError(f"{type(self).__name__} lacks a from_config classmethod")
                explicit = _get_args_from_config(from_cfg, *args, **kwargs)
                init_func(self, **explicit)
            else:
                init_func(self, *args, **kwargs)

        return wrapped

    def wrapper(orig_func):
        @functools.wraps(orig_func)
        def wrapped(*args, **kwargs):
            if _called_with_cfg(*args, **kwargs):
                explicit = _get_args_from_config(from_config, *args, **kwargs)
                return orig_func(**explicit)
            return orig_func(*args, **kwargs)

        wrapped.from_config = from_config
        return wrapped

    return wrapper


def _called_with_cfg(*args, **kwargs):
    if args and isinstance(args[0], CfgNode):
        return True
    return isinstance(kwargs.get("cfg"), CfgNode)


def _get_args_from_config(from_config_func, *args, **kwargs):
    """Call from_config, forwarding only the extra args it supports."""
    signature = inspect.signature(from_config_func)
    supports_var = any(
        p.kind == inspect.Parameter.VAR_KEYWORD for p in signature.parameters.values()
    )
    if supports_var:
        ret = from_config_func(*args, **kwargs)
    else:
        names = set(signature.parameters)
        extra = {k: kwargs.pop(k) for k in list(kwargs) if k not in names}
        ret = from_config_func(*args, **kwargs)
        ret.update(extra)
    return ret


def auto_scale_workers(cfg, num_workers: int):
    """Linear-scaling-rule rescale of a config written for
    ``cfg.SOLVER.REFERENCE_WORLD_SIZE`` workers (reference defaults.py:632):
    scales IMS_PER_BATCH, BASE_LR, MAX_ITER, STEPS, WARMUP_ITERS and eval
    period, and stamps the new world size. Returns a new (frozen-state
    preserved) config; no-op if REFERENCE_WORLD_SIZE is 0 or already equal."""
    old = cfg.SOLVER.get("REFERENCE_WORLD_SIZE", 0)
    if old == 0 or old == num_workers:
        return cfg
    was_frozen = cfg.is_frozen()
    cfg = cfg.clone()  # clone() defrosts
    cfg.defrost()
    scale = num_workers / old
    bs = cfg.SOLVER.IMS_PER_BATCH = int(round(cfg.SOLVER.IMS_PER_BATCH * scale))
    lr = cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR * scale
    mi = cfg.SOLVER.MAX_ITER = int(round(cfg.SOLVER.MAX_ITER / scale))
    cfg.SOLVER.STEPS = tuple(int(round(s / scale)) for s in cfg.SOLVER.STEPS)
    cfg.SOLVER.WARMUP_ITERS = int(round(cfg.SOLVER.WARMUP_ITERS / scale))
    if "EVAL_PERIOD" in cfg.TEST:
        cfg.TEST.EVAL_PERIOD = int(round(cfg.TEST.EVAL_PERIOD / scale))
    cfg.SOLVER.REFERENCE_WORLD_SIZE = num_workers
    import logging

    logging.getLogger("vnext_tpu_torch").info(
        "auto_scale_workers: batch=%d lr=%g max_iter=%d for %d workers",
        bs, lr, mi, num_workers,
    )
    if was_frozen:
        cfg.freeze()
    return cfg
