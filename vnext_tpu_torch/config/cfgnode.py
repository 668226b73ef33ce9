"""A yacs-style configuration tree: the port's copy of ``vnext_tpu.config.cfgnode``.

The same surface as the reference's ``detectron2.config.CfgNode``: attribute
access, yaml merge (with ``_BASE_``), dotted-list overrides, freezing, cloning
and ``dump``, on pyyaml alone. The port keeps its own copy so that it reads the
repository's config files without importing the JAX package;
``tests/test_torch_config.py`` holds both readers to the same dump.
"""

from __future__ import annotations

import copy
import io
from typing import Any, Dict, List

import yaml

_VALID_TYPES = (int, float, bool, str, type(None))


def _check_value(value: Any, full_key: str) -> Any:
    """Validate (and recursively convert) a value being inserted into a CfgNode."""
    if isinstance(value, CfgNode):
        return value
    if isinstance(value, dict):
        return CfgNode(value)
    if isinstance(value, (list, tuple)):
        return type(value)(_check_value(v, full_key) for v in value)
    if not isinstance(value, _VALID_TYPES):
        raise ValueError(
            f"Type {type(value)} is not valid for config key '{full_key}'; "
            f"valid leaf types: {_VALID_TYPES}"
        )
    return value


class CfgNode(dict):
    """Nested configuration node with attribute access, freezing and yaml IO."""

    IMMUTABLE = "__immutable__"
    NEW_ALLOWED = "__new_allowed__"

    def __init__(self, init_dict: Dict | None = None, new_allowed: bool = False):
        init_dict = init_dict or {}
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        self.__dict__[CfgNode.NEW_ALLOWED] = new_allowed
        for k, v in init_dict.items():
            self[k] = _check_value(v, k)

    # -- attribute <-> item access ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config key '{name}' not found")

    def __setattr__(self, name: str, value: Any) -> None:
        # yacs semantics: direct attribute writes may create new keys (that is how
        # default trees and add_*_config() extenders are built); only *merges*
        # reject unknown keys. Frozen nodes reject all writes.
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"CfgNode is frozen; cannot set key '{name}'")
        self[name] = _check_value(value, name)

    def __delattr__(self, name: str) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError("CfgNode is frozen")
        del self[name]

    # -- mutability ----------------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    def _set_immutable(self, value: bool) -> None:
        self.__dict__[CfgNode.IMMUTABLE] = value
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    def set_new_allowed(self, value: bool) -> None:
        self.__dict__[CfgNode.NEW_ALLOWED] = value
        for v in self.values():
            if isinstance(v, CfgNode):
                v.set_new_allowed(value)

    def is_new_allowed(self) -> bool:
        return self.__dict__[CfgNode.NEW_ALLOWED]

    # -- merging -------------------------------------------------------------------
    def clone(self) -> "CfgNode":
        cloned = copy.deepcopy(self)
        cloned._set_immutable(False)
        return cloned

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        _merge_a_into_b(other, self, self, [])

    def merge_from_file(self, cfg_filename: str, allow_unsafe: bool = True) -> None:
        with open(cfg_filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        # support detectron2-style _BASE_ inheritance
        base_key = "_BASE_"
        if base_key in loaded:
            import os

            base_file = loaded.pop(base_key)
            if not os.path.isabs(base_file):
                base_file = os.path.join(os.path.dirname(cfg_filename), base_file)
            self.merge_from_file(base_file, allow_unsafe=allow_unsafe)
        self.merge_from_other_cfg(CfgNode(loaded))

    def merge_from_list(self, cfg_list: List[Any]) -> None:
        """Merge 'KEY VALUE' pairs, e.g. from command-line ``opts``."""
        if len(cfg_list) % 2 != 0:
            raise ValueError(f"Override list has odd length: {cfg_list}")
        for full_key, v in zip(cfg_list[0::2], cfg_list[1::2]):
            key_parts = full_key.split(".")
            d = self
            for sub_key in key_parts[:-1]:
                if sub_key not in d:
                    raise KeyError(f"Non-existent key: {full_key}")
                d = d[sub_key]
            sub_key = key_parts[-1]
            if sub_key not in d and not d.is_new_allowed():
                raise KeyError(f"Non-existent key: {full_key}")
            value = _decode_cfg_value(v)
            if sub_key in d:
                value = _coerce_value_type(value, d[sub_key], full_key)
            dict.__setitem__(d, sub_key, value)

    # -- serialization ---------------------------------------------------------------
    def dump(self, **kwargs) -> str:
        def _to_dict(node):
            if isinstance(node, CfgNode):
                return {k: _to_dict(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [_to_dict(v) for v in node]
            return node

        kwargs.setdefault("default_flow_style", None)
        return yaml.safe_dump(_to_dict(self), **kwargs)

    def __str__(self) -> str:
        def _indent(s, n):
            pad = " " * n
            return "\n".join(pad + line if line else line for line in s.split("\n"))

        lines = []
        for k, v in sorted(self.items()):
            if isinstance(v, CfgNode):
                lines.append(f"{k}:")
                lines.append(_indent(str(v), 2))
            else:
                lines.append(f"{k}: {v}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


def _merge_a_into_b(a: CfgNode, b: CfgNode, root: CfgNode, key_list: List[str]) -> None:
    for k, v_ in a.items():
        full_key = ".".join(key_list + [k])
        if not isinstance(v_, (CfgNode, dict)):
            v_ = _decode_cfg_value(v_)
        if k in b:
            v = _coerce_value_type(v_, b[k], full_key)
            if isinstance(v, CfgNode) and isinstance(b[k], CfgNode):
                _merge_a_into_b(v, b[k], root, key_list + [k])
            else:
                dict.__setitem__(b, k, v)
        elif b.is_new_allowed():
            dict.__setitem__(b, k, v_)
        else:
            raise KeyError(f"Non-existent config key: {full_key}")


def _decode_cfg_value(value: Any) -> Any:
    """Decode a raw value (CLI string or yaml leaf) into a python object.

    Like yacs, strings that are python literals (e.g. '("a",)' tuples in yaml
    files) evaluate to their literal value.
    """
    import ast

    if isinstance(value, dict):
        return CfgNode(value)
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    try:
        return yaml.safe_load(io.StringIO(value))
    except yaml.YAMLError:
        return value


def _coerce_value_type(replacement: Any, original: Any, full_key: str) -> Any:
    original_type = type(original)
    replacement_type = type(replacement)
    if replacement_type == original_type or original is None or replacement is None:
        return replacement
    # allow int -> float promotion and list <-> tuple
    if isinstance(replacement, (int, float)) and isinstance(original, (int, float)) and not (
        isinstance(replacement, bool) != isinstance(original, bool)
    ):
        return original_type(replacement)
    if isinstance(replacement, (list, tuple)) and isinstance(original, (list, tuple)):
        return original_type(replacement)
    if isinstance(replacement, dict) and isinstance(original, CfgNode):
        return CfgNode(replacement)
    raise ValueError(
        f"Type mismatch ({replacement_type} vs {original_type}) for config key '{full_key}'"
    )


CN = CfgNode
