"""The port's box structures (``vnext_tpu.structures``' ``Boxes``, ``BoxMode``
and ``RotatedBoxes``)."""

from .boxes import BoxMode, Boxes, RotatedBoxes

__all__ = ["BoxMode", "Boxes", "RotatedBoxes"]
