"""Python-file ("lazy") configs.

Provides the same user surface as the reference's LazyConfig system
(detectron2/config/lazy.py:24,160): ``LazyCall`` wraps a callable into a declarative
``_target_`` node, ``instantiate`` recursively constructs it, and ``LazyConfig``
loads/saves python config files and applies dotted CLI overrides. Implemented on
plain dicts (no omegaconf dependency). The port's copy of
``vnext_tpu.config.lazy``.
"""

from __future__ import annotations

import ast
import builtins
import importlib
import os
import uuid
from typing import Any, Dict

import yaml


def locate(name: str) -> Any:
    """Locate an object by dotted path, e.g. 'vnext_tpu_torch.models.idol.IDOL'."""
    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        try:
            mod = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        obj = mod
        try:
            for p in parts[i:]:
                obj = getattr(obj, p)
        except AttributeError:
            continue
        return obj
    raise ImportError(f"Cannot locate object: {name}")


def _dotted_name(obj: Any) -> str:
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", None)
    if module and qualname:
        return f"{module}.{qualname}"
    raise ValueError(f"Cannot serialize target {obj!r} to a dotted path")


class LazyCall:
    """``LazyCall(fn)(a=1)`` produces ``{'_target_': fn, 'a': 1}`` for later instantiate."""

    def __init__(self, target: Any):
        if not (callable(target) or isinstance(target, str)):
            raise TypeError(f"LazyCall target must be callable or str, got {target!r}")
        self._target = target

    def __call__(self, **kwargs) -> Dict[str, Any]:
        return {"_target_": self._target, **kwargs}


def instantiate(cfg: Any) -> Any:
    """Recursively instantiate ``_target_`` nodes bottom-up."""
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(instantiate(v) for v in cfg)
    if isinstance(cfg, dict):
        kwargs = {k: instantiate(v) for k, v in cfg.items() if k != "_target_"}
        if "_target_" in cfg:
            target = cfg["_target_"]
            if isinstance(target, str):
                target = locate(target)
            return target(**kwargs)
        return kwargs
    return cfg


class _ConfigDict(dict):
    """Dict with attribute access, used as the namespace of loaded lazy configs."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict) and not isinstance(obj, _ConfigDict):
        return _ConfigDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_wrap(v) for v in obj]
    return obj


class LazyConfig:
    """Load/save python-file configs and apply dotted overrides."""

    @staticmethod
    def load(filename: str, keys: str | None = None) -> Any:
        filename = os.path.abspath(filename)
        with open(filename, "r") as f:
            content = f.read()
        module_namespace: Dict[str, Any] = {
            "__file__": filename,
            "__name__": "vnext_tpu_torch._lazy_cfg_" + uuid.uuid4().hex[:8],
            "__builtins__": builtins,
        }
        exec(compile(content, filename, "exec"), module_namespace)
        ret = _ConfigDict(
            {
                k: _wrap(v)
                for k, v in module_namespace.items()
                if not k.startswith("_") and not isinstance(v, type(os))
            }
        )
        if keys is not None:
            parts = keys.split(".")
            obj: Any = ret
            for p in parts:
                obj = obj[p] if isinstance(obj, dict) else getattr(obj, p)
            return obj
        return ret

    @staticmethod
    def apply_overrides(cfg: Any, overrides: list[str]) -> Any:
        for o in overrides:
            if "=" not in o:
                raise ValueError(f"Override must be key=value, got: {o}")
            key, value = o.split("=", 1)
            try:
                value = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                pass  # keep as string
            parts = key.split(".")
            obj = cfg
            for p in parts[:-1]:
                obj = obj[p] if isinstance(obj, dict) else getattr(obj, p)
            if isinstance(obj, dict):
                obj[parts[-1]] = value
            else:
                setattr(obj, parts[-1], value)
        return cfg

    @staticmethod
    def save(cfg: Any, filename: str) -> None:
        def _to_plain(node):
            if isinstance(node, dict):
                out = {}
                for k, v in node.items():
                    if k == "_target_" and not isinstance(v, str):
                        out[k] = _dotted_name(v)
                    else:
                        out[k] = _to_plain(v)
                return out
            if isinstance(node, (list, tuple)):
                return [_to_plain(v) for v in node]
            if isinstance(node, (int, float, bool, str, type(None))):
                return node
            return repr(node)

        with open(filename, "w") as f:
            yaml.safe_dump(_to_plain(cfg), f, default_flow_style=None)

    @staticmethod
    def to_py(cfg: Any, prefix: str = "cfg.") -> str:
        """Render a config tree as executable python statements (reference
        config/lazy.py:399 LazyConfig.to_py): LazyCall nodes print as
        ``L(target)(...)`` expressions, everything else as assignments."""

        def _expr(node) -> str:
            if isinstance(node, dict) and "_target_" in node:
                target = node["_target_"]
                tname = target if isinstance(target, str) else _dotted_name(target)
                args = ", ".join(
                    f"{k}={_expr(v)}" for k, v in sorted(node.items()) if k != "_target_"
                )
                return f"L({tname})({args})"
            if isinstance(node, dict):
                inner = ", ".join(f"{k!r}: {_expr(v)}" for k, v in sorted(node.items()))
                return "{" + inner + "}"
            if isinstance(node, (list, tuple)):
                inner = ", ".join(_expr(v) for v in node)
                return f"[{inner}]" if isinstance(node, list) else f"({inner})"
            return repr(node)

        lines = []
        for k in sorted(cfg) if isinstance(cfg, dict) else []:
            lines.append(f"{prefix}{k} = {_expr(cfg[k])}")
        return "\n".join(lines) + "\n"
