"""Dataset and metadata catalogs.

Counterpart of ``vnext_tpu.data.catalog`` (detectron2's ``DatasetCatalog`` and
``MetadataCatalog``): ``DatasetCatalog`` maps a dataset name to a function of
no arguments that returns its records; ``MetadataCatalog`` holds each dataset's
constants (class names, the id map, the json file, the evaluator type).
"""

from __future__ import annotations

import types
from typing import Any, Callable, Dict, List


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable[[], List[dict]]] = {}

    def register(self, name: str, func: Callable[[], List[dict]]) -> None:
        if name in self._registry:
            raise ValueError(f"Dataset '{name}' is already registered")
        if not callable(func):
            raise TypeError("you must register a callable")
        self._registry[name] = func

    def get(self, name: str) -> List[dict]:
        try:
            f = self._registry[name]
        except KeyError as e:
            raise KeyError(
                f"Dataset '{name}' is not registered. Available: {sorted(self._registry)}"
            ) from e
        return f()

    def list(self) -> List[str]:
        return sorted(self._registry)

    def remove(self, name: str) -> None:
        del self._registry[name]

    def __contains__(self, name: str) -> bool:
        return name in self._registry

    def clear(self) -> None:
        self._registry.clear()


class Metadata(types.SimpleNamespace):
    """Attribute bag; setting an existing attribute to a new value is an error."""

    name: str = "N/A"

    def __setattr__(self, key: str, val: Any) -> None:
        if hasattr(self, key) and key != "name":
            old = getattr(self, key)
            if old != val:
                raise AttributeError(
                    f"Metadata '{key}' for dataset '{self.name}' cannot be overwritten "
                    f"({old!r} -> {val!r})"
                )
        super().__setattr__(key, val)

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def set(self, **kwargs) -> "Metadata":
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


class _MetadataCatalog:
    def __init__(self):
        self._store: Dict[str, Metadata] = {}

    def get(self, name: str) -> Metadata:
        if name not in self._store:
            self._store[name] = Metadata(name=name)
        return self._store[name]

    def list(self) -> List[str]:
        return sorted(self._store)

    def remove(self, name: str) -> None:
        del self._store[name]

    def __contains__(self, name: str) -> bool:
        return name in self._store


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
