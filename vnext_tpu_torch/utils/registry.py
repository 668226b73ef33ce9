"""Name -> object registry (reference surface: detectron2/utils/registry.py:40, fvcore Registry).

The port's own copy of ``vnext_tpu.utils.registry``."""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple


class Registry:
    """Registry mapping names to callables/classes, supporting decorator registration.

    Example::

        META_ARCH_REGISTRY = Registry("META_ARCH")

        @META_ARCH_REGISTRY.register()
        class IDOL: ...

        model_cls = META_ARCH_REGISTRY.get("IDOL")
    """

    def __init__(self, name: str):
        self._name = name
        self._obj_map: Dict[str, Any] = {}

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._obj_map:
            raise KeyError(f"'{name}' already registered in '{self._name}' registry")
        self._obj_map[name] = obj

    def register(self, obj: Any = None):
        if obj is None:
            def deco(func_or_class):
                self._do_register(func_or_class.__name__, func_or_class)
                return func_or_class

            return deco
        self._do_register(obj.__name__, obj)
        return obj

    def get(self, name: str) -> Any:
        if name not in self._obj_map:
            raise KeyError(
                f"No object named '{name}' in '{self._name}' registry. "
                f"Available: {sorted(self._obj_map)}"
            )
        return self._obj_map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self._obj_map.items())

    def keys(self):
        return self._obj_map.keys()

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={sorted(self._obj_map)})"
