"""Fixed-capacity ``Instances`` (reference surface: detectron2/structures/instances.py:7).

Counterpart of ``vnext_tpu.structures.instances``: every field is padded to one
leading ``capacity`` and a bool ``valid`` field marks the real objects, so a
detector's outputs keep one shape whatever an image holds. A plain class over
tensors (or numpy arrays); ``image_size`` is (h, w).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _cat(values):
    if isinstance(values[0], torch.Tensor):
        return torch.cat(values, 0)
    return np.concatenate([np.asarray(v) for v in values], 0)


def _pad(v, capacity: int, fill):
    n = v.shape[0]
    if isinstance(v, torch.Tensor):
        tail = torch.full((capacity - n, *v.shape[1:]), fill, dtype=v.dtype, device=v.device)
        return torch.cat([v, tail], 0)
    v = np.asarray(v)
    return np.pad(v, [(0, capacity - n)] + [(0, 0)] * (v.ndim - 1), constant_values=fill)


class Instances:
    def __init__(self, image_size: Tuple[int, int], **fields):
        self._image_size = tuple(int(s) for s in image_size)
        self._fields: Dict[str, Any] = {}
        for k, v in fields.items():
            self.set(k, v)

    @property
    def image_size(self) -> Tuple[int, int]:
        return self._image_size

    def __setattr__(self, name: str, val: Any) -> None:
        if name.startswith("_"):
            super().__setattr__(name, val)
        else:
            self.set(name, val)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_") or name not in self._fields:
            raise AttributeError(f"Instances has no field '{name}'")
        return self._fields[name]

    def set(self, name: str, value: Any) -> None:
        n = self.capacity
        if hasattr(value, "shape") and n is not None and value.shape[0] != n:
            raise ValueError(f"Field '{name}' has leading dim {value.shape[0]}, expected {n}")
        self._fields[name] = value

    def has(self, name: str) -> bool:
        return name in self._fields

    def remove(self, name: str) -> None:
        del self._fields[name]

    def get(self, name: str) -> Any:
        return self._fields[name]

    def get_fields(self) -> Dict[str, Any]:
        return self._fields

    @property
    def capacity(self) -> Optional[int]:
        for v in self._fields.values():
            if hasattr(v, "shape") and len(v.shape) > 0:
                return v.shape[0]
        return None

    def __len__(self) -> int:
        n = self.capacity
        if n is None:
            raise NotImplementedError("Empty Instances does not support __len__")
        return n

    def num_valid(self) -> int:
        """Number of real (non-padding) instances."""
        if "valid" in self._fields:
            return int(self._fields["valid"].sum())
        return self.capacity or 0

    def __getitem__(self, item) -> "Instances":
        ret = Instances(self._image_size)
        for k, v in self._fields.items():
            ret.set(k, v[item])
        return ret

    def to_numpy(self) -> "Instances":
        ret = Instances(self._image_size)
        for k, v in self._fields.items():
            ret.set(k, v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        return ret

    @staticmethod
    def cat(instance_lists) -> "Instances":
        if not instance_lists:
            raise ValueError("Instances.cat: nothing to concatenate")
        ret = Instances(instance_lists[0].image_size)
        for k in instance_lists[0]._fields:
            ret.set(k, _cat([i.get(k) for i in instance_lists]))
        return ret

    def pad_to(self, capacity: int, pad_values: Optional[Dict[str, Any]] = None) -> "Instances":
        """Every field padded to ``capacity`` (with ``pad_values[name]``, else 0),
        and a ``valid`` field made (the first n True) where there is none."""
        pad_values = pad_values or {}
        n = self.capacity or 0
        if n > capacity:
            raise ValueError(f"Cannot pad {n} instances into capacity {capacity}")
        ret = Instances(self._image_size)
        first = None
        for k, v in self._fields.items():
            ret.set(k, _pad(v, capacity, pad_values.get(k, 0)))
            first = v if first is None else first
        if "valid" not in self._fields:
            if isinstance(first, torch.Tensor):
                ret.set("valid", torch.arange(capacity, device=first.device) < n)
            else:
                ret.set("valid", np.arange(capacity) < n)
        return ret

    def __repr__(self) -> str:
        desc = ", ".join(f"{k}: {tuple(getattr(v, 'shape', ())) or type(v).__name__}"
                         for k, v in self._fields.items())
        return f"Instances(capacity={self.capacity}, image_size={self._image_size}, fields=[{desc}])"
