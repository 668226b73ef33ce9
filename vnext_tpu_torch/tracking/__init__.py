"""The port's trackers: IDOL's (``idol_tracker``, on the host;
``idol_tracker_device``, on the card) and the frame-to-frame box trackers."""

from .bbox_trackers import (BaseTracker, BBoxIOUTracker, IOUWeightedHungarianBBoxIOUTracker,
                            VanillaHungarianBBoxIOUTracker)

__all__ = ["BaseTracker", "BBoxIOUTracker", "IOUWeightedHungarianBBoxIOUTracker", "VanillaHungarianBBoxIOUTracker"]
