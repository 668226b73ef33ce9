"""Test-time augmentation and the box trackers in the port against the JAX
package, on the CPU in f32.

- ``DetectorWithTTA`` on a synthetic detector (the same numpy detections of
  each variant's shape in both packages): the mapped-back boxes, the merge's
  keep sets and the top detections equal JAX's (boxes at 1e-5 relative: the
  maps' f32 products).
- ``GeneralizedRCNNWithTTA`` around a tiny Mask R-CNN (tests/test_torch_rcnn.py's:
  ResNet-18, FPN 32 channels, 4 classes, 8 detections), one 48x64 image at
  shorter sides 31 and 40 with flip: the variants are 31x41 and 40x53, odd
  sides that the stem pads. The merged slots, classes and keep sets exactly,
  boxes and scores at 2e-4 of their largest and the flip-averaged masks at
  2e-4 (as tests/test_torch_rcnn.py holds the model: f32 convolutions summed
  in other orders). JAX's model runs jitted once per (method, shape).
- The trackers: ``BBoxIOUTracker``, ``VanillaHungarianBBoxIOUTracker`` and
  ``IOUWeightedHungarianBBoxIOUTracker`` give JAX's ids, frame by frame, over a
  seeded sequence of detections that move, vanish, reappear and change class.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.rcnn import GeneralizedRCNN as JaxRCNN
from vnext_tpu.models.tta import DetectorWithTTA as JaxDetectorWithTTA
from vnext_tpu.models.tta import GeneralizedRCNNWithTTA as JaxGeneralizedRCNNWithTTA
from vnext_tpu.tracking import bbox_trackers as jax_trackers
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.models import DetectorWithTTA, GeneralizedRCNNWithTTA
from vnext_tpu_torch.models.rcnn import GeneralizedRCNN
from vnext_tpu_torch.tracking import (BaseTracker, BBoxIOUTracker, IOUWeightedHungarianBBoxIOUTracker,
                                      VanillaHungarianBBoxIOUTracker)

from _torch_helpers import random_params, t

torch.set_num_threads(2)

TINY = dict(num_classes=4, backbone_depth=18, fpn_channels=32, proposals_per_image=32, max_detections=8)
MIN_SIZES = (31, 40)


def _synthetic_detections(h, w, flipped_seed=0):
    """Detections of a [1, h, w, 3] variant, from its shape alone: 12 boxes in
    its frame, scores on a grid (no ties), 3 classes, a few invalid."""
    rng = np.random.RandomState(h * 1000 + w + flipped_seed)
    xy = rng.uniform(0, 0.7, (1, 12, 2)) * [w, h]
    boxes = np.concatenate([xy, xy + rng.uniform(0.1, 0.3, (1, 12, 2)) * [w, h]], -1).astype(np.float32)
    scores = (rng.permutation(12)[None] / 12 + 0.02 + 0.001 * flipped_seed).astype(np.float32)
    return boxes, scores, rng.randint(0, 3, (1, 12)), rng.rand(1, 12) < 0.85


def test_detector_with_tta_merges_like_jax():
    images = np.random.RandomState(0).randn(1, 48, 64, 3).astype(np.float32)

    def jax_infer(x):
        b, s, c, v = _synthetic_detections(*x.shape[1:3], flipped_seed=int(float(x[0, 0, 0, 0]) > 0))
        return {"boxes": jnp.asarray(b), "scores": jnp.asarray(s), "classes": jnp.asarray(c), "valid": jnp.asarray(v)}

    def port_infer(x):
        b, s, c, v = _synthetic_detections(*x.shape[1:3], flipped_seed=int(float(x[0, 0, 0, 0]) > 0))
        return {"boxes": t(b), "scores": t(s), "classes": torch.from_numpy(c), "valid": torch.from_numpy(v)}

    kw = dict(min_sizes=(30, 45, 57), flip=True, nms_thresh=0.5, max_detections=60)
    want = JaxDetectorWithTTA(jax_infer, **kw)(jnp.asarray(images))
    got = DetectorWithTTA(port_infer, **kw)(t(images))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    v = got["valid"].numpy()
    assert 0 < v.sum() < 60
    np.testing.assert_array_equal(got["classes"].numpy()[v], np.asarray(want["classes"])[v])
    np.testing.assert_array_equal(got["scores"].numpy(), np.asarray(want["scores"]))
    np.testing.assert_allclose(got["boxes"].numpy()[v], np.asarray(want["boxes"])[v], rtol=1e-5, atol=1e-5)


class _JittedRCNN:
    """The JAX model as ``GeneralizedRCNNWithTTA`` calls it (``apply`` with a
    ``method``), each (method, shapes) jitted once."""

    mask_on = True
    inference = JaxRCNN.inference
    inference_masks_on_boxes = JaxRCNN.inference_masks_on_boxes

    def __init__(self, module):
        self.module, self.compiled = module, {}

    def apply(self, variables, *args, method):
        key = (method.__name__, tuple(a.shape for a in args))
        if key not in self.compiled:
            self.compiled[key] = jax.jit(lambda v, *a: self.module.apply(v, *a, method=method))
        return self.compiled[key](variables, *args)


def test_generalized_rcnn_with_tta_matches_jax():
    images = np.random.RandomState(1).randn(1, 48, 64, 3).astype(np.float32)
    sizes = np.asarray([[48, 64]], np.int32)
    module = JaxRCNN(mask_on=True, **TINY)
    params = random_params(lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(sizes),
                                               method=JaxRCNN.inference), seed=3)
    kw = dict(min_sizes=MIN_SIZES, flip=True, max_detections=8)
    jwrapped = _JittedRCNN(module)
    want = JaxGeneralizedRCNNWithTTA(jwrapped, params, jnp.asarray(sizes), **kw)(jnp.asarray(images))
    assert sorted({k[1][0][1:3] for k in jwrapped.compiled}) == [(31, 41), (40, 53)]
    port = GeneralizedRCNN(mask_on=True, **TINY).eval()
    load_from_jax(port, params)
    got = GeneralizedRCNNWithTTA(port, torch.from_numpy(sizes), **kw)(t(images))
    want = jax.tree.map(np.asarray, want)
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    v = want["valid"]
    assert v.sum() > 0, "the random weights must give detections"
    np.testing.assert_array_equal(got["classes"].numpy()[v], want["classes"][v])
    for k in ("scores", "boxes", "mask_probs"):
        g, w = got[k].numpy()[v], want[k][v]
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * max(1.0, np.abs(w).max()), err_msg=k)


# ---------------------------------------------------------------- trackers
def _detection_sequence(seed, frames=8):
    """Per frame {boxes [N, 4], classes [N], scores [N]}: 6 objects drifting,
    each missing from a frame now and then, one changing class, and strays."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, 200, (6, 2))
    size = rng.uniform(20, 60, (6, 2))
    cls = rng.randint(0, 2, 6)
    seq = []
    for f in range(frames):
        xy = base + f * rng.uniform(-6, 6, (6, 2))
        here = rng.rand(6) < 0.8
        boxes = np.concatenate([xy, xy + size], 1)[here]
        c = cls.copy()
        c[0] = f % 2
        c = c[here]
        n_stray = rng.randint(0, 3)
        stray_xy = rng.uniform(0, 250, (n_stray, 2))
        boxes = np.concatenate([boxes, np.concatenate([stray_xy, stray_xy + 15], 1)]).astype(np.float32)
        c = np.concatenate([c, rng.randint(0, 2, n_stray)])
        order = rng.permutation(len(boxes))
        seq.append({"boxes": boxes[order], "classes": c[order],
                    "scores": rng.uniform(0.3, 1.0, len(boxes)).astype(np.float32)})
    return seq


@pytest.mark.parametrize("name", ["BBoxIOUTracker", "VanillaHungarianBBoxIOUTracker",
                                  "IOUWeightedHungarianBBoxIOUTracker"])
def test_bbox_trackers_give_jax_ids(name):
    port_cls = {"BBoxIOUTracker": BBoxIOUTracker, "VanillaHungarianBBoxIOUTracker": VanillaHungarianBBoxIOUTracker,
                "IOUWeightedHungarianBBoxIOUTracker": IOUWeightedHungarianBBoxIOUTracker}[name]
    for thr in (0.3, 0.5):
        port, jx = port_cls(track_iou_threshold=thr), getattr(jax_trackers, name)(track_iou_threshold=thr)
        seq = _detection_sequence(17)
        for frame in seq:
            tensors = {k: torch.from_numpy(v) for k, v in frame.items()}     # the port takes tensors too
            got, want = port.update(tensors)["ids"], jx.update(frame)["ids"]
            np.testing.assert_array_equal(got, want)
        # some ids were carried across frames: fewer ids than detections
        assert port._next_id == jx._next_id < sum(len(f["boxes"]) for f in seq)
        port.reset()
        assert port._next_id == 0 and port._prev is None
    with pytest.raises(NotImplementedError):
        BaseTracker().update({"boxes": np.zeros((0, 4))})
