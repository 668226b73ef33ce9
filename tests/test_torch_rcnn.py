"""GeneralizedRCNN serving in the port (Mask R-CNN and Faster R-CNN) against
the JAX package's ``vnext_tpu.models.rcnn``, on the CPU in f32.

One tiny Mask R-CNN (ResNet-18, FPN 32 channels, 4 classes, 32 proposals, 8
detections, two images at 64x96 with true sizes 64x85 and 56x96) is built once
from a random flax tree (``random_params``: no init is compiled), bridged to
the port by ``load_from_jax`` (no key left over either way), and one jitted
JAX function returns every stage: the FPN maps, the RPN's logits, deltas and
proposals, the ROI heads on those proposals, the detections, and the mask
branch on the detected boxes. Each port stage runs on JAX's own inputs for
that stage, so a discrete choice upstream (a top-k or NMS decision that an
f32 rounding could flip) cannot move the comparison of a later stage.

Tolerances: geometry (anchors, the box transform, the matcher, levels, ROI
pooling, mask pasting, the transposed convolution) 1e-5 relative or tighter,
indices and labels exact; stages after convolutions at 2e-4 of each output's
largest magnitude, as tests/test_torch_resnet_basic.py holds the trunk (f32
sums of the convolutions in other orders); kept indices, classes and counts
exact.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.dense_heads import Box2BoxTransform as JaxBox2Box
from vnext_tpu.models.dense_heads import anchors_for_level as jax_anchors_for_level
from vnext_tpu.models.dense_heads import generate_cell_anchors as jax_cell_anchors
from vnext_tpu.models.dense_heads import iou_matcher as jax_iou_matcher
from vnext_tpu.models.rcnn import GeneralizedRCNN as JaxRCNN
from vnext_tpu.models.rcnn import assign_fpn_levels as jax_assign_fpn_levels
from vnext_tpu.ops.mask_ops import paste_masks_in_image as jax_paste
from vnext_tpu.ops.roi_align import roi_align as jax_roi_align
from vnext_tpu.structures.boxes import clip_boxes as jax_clip_boxes
from vnext_tpu.structures.boxes import nonempty_boxes as jax_nonempty
from vnext_tpu.structures.image_list import ImageList as JaxImageList
from vnext_tpu.structures.instances import Instances as JaxInstances
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.models.dense_heads import Box2BoxTransform, anchors_for_level, generate_cell_anchors, iou_matcher
from vnext_tpu_torch.models.layers import ConvTranspose
from vnext_tpu_torch.models.rcnn import DetTargets, GeneralizedRCNN, StandardROIHeads, assign_fpn_levels
from vnext_tpu_torch.ops.mask_ops import paste_masks_in_image
from vnext_tpu_torch.ops.roi_align import roi_align, roi_align_levels
from vnext_tpu_torch.structures.boxes import Boxes, box_xyxy_to_cxcywh, clip_boxes, nonempty_boxes
from vnext_tpu_torch.structures.image_list import ImageList
from vnext_tpu_torch.structures.instances import Instances

from _torch_helpers import random_params, t

torch.set_num_threads(2)

H, W = 64, 96
SIZES = np.asarray([[64, 85], [56, 96]], np.int32)
TINY = dict(num_classes=4, backbone_depth=18, fpn_channels=32, proposals_per_image=32, max_detections=8)


def _close(got, want, scale=2e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * max(1.0, np.abs(want).max()))


def _nchw(x):
    return t(np.asarray(x)).permute(0, 3, 1, 2)


def _stages(m, images, sizes):
    """Every stage of JAX's inference in one trace."""
    feats = m._features(images)
    proposals, _, anchors, logits, deltas = m.rpn([feats[f"p{i}"] for i in range(2, 7)], sizes, train=False)
    head = m.roi_heads(feats, proposals)
    out = m.inference_on_features(feats, sizes)
    on_boxes = m.inference_masks_on_boxes(images, out["boxes"], out["classes"])
    return feats, (proposals, anchors, logits, deltas), head, out, on_boxes


@pytest.fixture(scope="module")
def tiny():
    images = np.random.RandomState(0).randn(2, H, W, 3).astype(np.float32)
    jmodel = JaxRCNN(mask_on=True, **TINY)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(SIZES),
                                               method=JaxRCNN.inference), seed=3)
    stages = jax.jit(lambda p, x, s: jmodel.apply({"params": p}, x, s, method=_stages))(
        params, jnp.asarray(images), jnp.asarray(SIZES))
    stages = jax.tree.map(np.asarray, stages)
    port = GeneralizedRCNN(mask_on=True, **TINY).eval()
    load_from_jax(port, params)
    return images, params, stages, port


# ---------------------------------------------------------------- geometry
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("scale", [1 / 4, 1 / 8, 1 / 16, 1 / 32])
def test_roi_align_matches_jax(aligned, scale):
    """ROIs across every border (and wholly outside), on three batch images;
    1e-5 relative to the map's largest value (f32: two products per sample)."""
    rng = np.random.RandomState(int(1 / scale))
    feats = rng.randn(3, 9, 13, 5).astype(np.float32)
    h, w = feats.shape[1] / scale, feats.shape[2] / scale
    x1 = rng.uniform(-0.3 * w, 1.1 * w, 40)
    y1 = rng.uniform(-0.3 * h, 1.1 * h, 40)
    bw, bh = rng.uniform(0.5 / scale, 0.8 * w, 40), rng.uniform(0.5 / scale, 0.8 * h, 40)
    rois = np.stack([rng.randint(0, 3, 40), x1, y1, x1 + bw, y1 + bh], 1).astype(np.float32)
    rois[:4, 1:] = [[-2 * w, -h, -w, -h / 2], [0, 0, w, h], [-w, -h, 2 * w, 2 * h], [w - 1, h - 1, w + 5, h + 5]]
    want = jax.jit(lambda f, r: jax_roi_align(f, r, (7, 7), spatial_scale=scale, aligned=aligned))(feats, rois)
    got = roi_align(_nchw(feats), t(rois), (7, 7), spatial_scale=scale, aligned=aligned)
    _close(got, want, 1e-5)


def test_roi_align_levels_equals_each_levels_pool():
    rng = np.random.RandomState(7)
    maps = [rng.randn(2, 5, 16 // 2 ** i, 24 // 2 ** i).astype(np.float32) for i in range(4)]
    rois = np.concatenate([rng.randint(0, 2, (30, 1)), rng.uniform(-10, 90, (30, 4))], 1).astype(np.float32)
    rois[:, 3:] = rois[:, 1:3] + np.abs(rois[:, 3:]) + 1
    levels = rng.randint(0, 4, 30)
    got = roi_align_levels([t(m) for m in maps], t(rois), torch.from_numpy(levels), [4, 8, 16, 32])
    for lv in range(4):
        sel = levels == lv
        want = roi_align(t(maps[lv]), t(rois[sel]), spatial_scale=1 / 4 / 2 ** lv)
        assert torch.equal(got[torch.from_numpy(sel)], want), lv


def test_paste_masks_matches_jax():
    """Boxes inside, across the border, and smaller than a pixel; the f32
    probabilities at 1e-5 relative, the thresholded masks equal wherever the
    probability is 1e-5 or more from the threshold."""
    rng = np.random.RandomState(1)
    masks = rng.rand(6, 14, 14).astype(np.float32)
    boxes = np.asarray([[3, 4, 40, 30], [-10, -5, 20, 25], [30, 20, 70, 60], [10, 10, 10.4, 10.3],
                        [0, 0, 64, 48], [50.5, 2.25, 63.75, 47.5]], np.float32)
    want = np.asarray(jax.jit(lambda m, b: jax_paste(m, b, (48, 64), threshold=-1))(masks, boxes))
    got = paste_masks_in_image(t(masks), t(boxes), (48, 64), threshold=-1).numpy()
    _close(got, want, 1e-5)
    far = np.abs(want - 0.5) > 1e-5
    assert np.array_equal(paste_masks_in_image(t(masks), t(boxes), (48, 64)).numpy()[far], (want >= 0.5)[far])


def test_anchors_match_jax():
    cell = generate_cell_anchors((32,), (0.5, 1.0, 2.0))
    np.testing.assert_array_equal(cell, jax_cell_anchors((32,), (0.5, 1.0, 2.0)))
    np.testing.assert_array_equal(generate_cell_anchors(), jax_cell_anchors())
    for h, w, stride in ((5, 7, 4), (3, 2, 64), (1, 1, 16)):
        got = anchors_for_level(h, w, stride, cell).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_anchors_for_level(h, w, stride, cell)))
    # (y, x, anchor) order: the second anchor of cell (row 0, column 1) is 4 + 1
    a = anchors_for_level(2, 3, 8, cell).numpy().reshape(2, 3, 3, 4)
    centres = np.stack(np.meshgrid(np.arange(3) * 8 + 4, np.arange(2) * 8 + 4), -1)[:, :, None]
    np.testing.assert_allclose((a[..., :2] + a[..., 2:]) / 2, np.broadcast_to(centres, (2, 3, 3, 2)), atol=1e-5)


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)], ids=["rpn", "roi"])
def test_box2box_matches_jax(weights):
    """Both directions, with deltas past the scale clamp; 1e-5 relative."""
    rng = np.random.RandomState(2)
    src = rng.uniform(0, 50, (40, 4)).astype(np.float32)
    src[:, 2:] = src[:, :2] + rng.uniform(1, 60, (40, 2))
    tgt = rng.uniform(0, 50, (40, 4)).astype(np.float32)
    tgt[:, 2:] = tgt[:, :2] + rng.uniform(1, 60, (40, 2))
    deltas = rng.randn(40, 4).astype(np.float32) * 3
    deltas[:5, 2:] = 40.0                                      # past log(1000 / 16) x the weights
    jb, pb = JaxBox2Box(weights), Box2BoxTransform(weights)
    want_deltas, want_boxes = jax.jit(lambda s_, t_, d: (jb.get_deltas(s_, t_), jb.apply_deltas(d, s_)))(src, tgt, deltas)
    np.testing.assert_allclose(pb.get_deltas(t(src), t(tgt)).numpy(), np.asarray(want_deltas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pb.apply_deltas(t(deltas), t(src)).numpy(), np.asarray(want_boxes), rtol=1e-5)
    np.testing.assert_allclose(pb.apply_deltas(pb.get_deltas(t(src), t(tgt)), t(src)).numpy(), tgt, rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("low_quality", [True, False])
def test_iou_matcher_matches_jax(low_quality):
    """Matched indices and labels exact; an invalid ground truth never matches."""
    rng = np.random.RandomState(3)
    anchors = rng.uniform(0, 80, (200, 4)).astype(np.float32)
    anchors[:, 2:] = anchors[:, :2] + rng.uniform(4, 40, (200, 2))
    gt = np.concatenate([anchors[[3, 50, 120]] + rng.randn(3, 4).astype(np.float32), [[0, 0, 5, 5]]]).astype(np.float32)
    gt[1] = anchors[50]                          # an exact copy: IoU 1 with its anchor
    valid = np.asarray([True, True, True, False])
    want = jax.jit(lambda g, v, a: jax_iou_matcher(g, v, a, (0.3, 0.7), low_quality))(gt, valid, anchors)
    got = iou_matcher(t(gt), torch.from_numpy(valid), t(anchors), (0.3, 0.7), low_quality)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (got[1].numpy() == 1).sum() > 0 and 3 not in got[0].numpy()[got[1].numpy() == 1]


def test_assign_fpn_levels_matches_jax():
    rng = np.random.RandomState(4)
    rois = rng.uniform(0, 500, (300, 4)).astype(np.float32)
    rois[:, 2:] = rois[:, :2] + rng.uniform(0, 800, (300, 2))
    rois[:3] = [[0, 0, 56, 56], [0, 0, 224, 224], [5, 5, 5, 5]]
    for kmin, kmax in ((2, 5), (3, 7)):
        got = assign_fpn_levels(t(rois), kmin=kmin, kmax=kmax).numpy()
        want = jax.jit(lambda r: jax_assign_fpn_levels(r, kmin=kmin, kmax=kmax))(rois)
        np.testing.assert_array_equal(got, np.asarray(want))
    assert assign_fpn_levels(t(rois[:3])).tolist() == [2, 4, 2]


def test_mask_deconv_matches_flax_conv_transpose():
    """The mask head's 2x2 stride-2 flax ConvTranspose (transpose_kernel False,
    "SAME"): out[2i + a] = x[i] . K[1 - a]. A kernel whose taps all differ, so
    a missing flip or swap fails; 1e-5 relative."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 7, 7, 6).astype(np.float32)
    flax_layer = fnn.ConvTranspose(4, (2, 2), strides=(2, 2))
    kernel = (np.arange(2 * 2 * 6 * 4).reshape(2, 2, 6, 4) * 0.37 % 1.9 - 0.8).astype(np.float32)
    params = {"kernel": kernel, "bias": rng.randn(4).astype(np.float32)}
    want = np.asarray(flax_layer.apply({"params": params}, jnp.asarray(x)))
    port = ConvTranspose(6, 4, 2, 2)
    load_from_jax(port, params)
    with torch.no_grad():
        got = port(_nchw(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (3, 14, 14, 4)
    _close(got, want, 1e-5)
    flipped = params | {"kernel": kernel[::-1, ::-1].copy()}
    assert not np.allclose(np.asarray(flax_layer.apply({"params": flipped}, jnp.asarray(x))), want, atol=1e-3)


# ---------------------------------------------------------------- structures
def test_structures_match_jax():
    rng = np.random.RandomState(6)
    boxes = rng.uniform(-20, 120, (10, 4)).astype(np.float32)
    np.testing.assert_array_equal(clip_boxes(t(boxes), (50, 90)).numpy(),
                                  np.asarray(jax_clip_boxes(jnp.asarray(boxes), (50, 90))))
    np.testing.assert_array_equal(nonempty_boxes(t(boxes), 2.0).numpy(),
                                  np.asarray(jax_nonempty(jnp.asarray(boxes), 2.0)))
    b = Boxes(boxes)
    assert len(b[2]) == 1 and len(Boxes.cat([b, b[:3]])) == 13
    np.testing.assert_array_equal(b.clip((50, 90)).tensor.numpy(), clip_boxes(t(boxes), (50, 90)).numpy())
    np.testing.assert_allclose(box_xyxy_to_cxcywh(t(boxes))[:, :2].numpy(), b.get_centers().numpy())
    np.testing.assert_allclose(b.scale(2.0, 0.5).area().numpy(), b.area().numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match=r"\(N, 4\)"):
        Boxes(np.zeros((3, 5)))

    images = [rng.randint(0, 255, (30, 40, 3)).astype(np.float32), rng.randint(0, 255, (20, 50, 3)).astype(np.float32)]
    for target in (None, (64, 64)):
        got = ImageList.from_arrays(images, target_size=target)
        want = JaxImageList.from_arrays(images, target_size=target)
        np.testing.assert_array_equal(got.tensor.numpy(), np.asarray(want.tensor))
        np.testing.assert_array_equal(got.image_sizes.numpy(), np.asarray(want.image_sizes))
        np.testing.assert_array_equal(got.padding_mask().numpy(), np.asarray(want.padding_mask()))
        assert got.padded_size == want.padded_size
    with pytest.raises(ValueError, match="larger than padded size"):
        ImageList.from_arrays(images, target_size=(16, 16))

    fields = dict(boxes=boxes[:3], labels=np.asarray([1, 2, 0], np.int32))
    got = Instances((50, 90), **{k: torch.from_numpy(v) for k, v in fields.items()}).pad_to(5, {"labels": -1})
    want = JaxInstances((50, 90), **{k: jnp.asarray(v) for k, v in fields.items()}).pad_to(5, {"labels": -1})
    for k in ("boxes", "labels", "valid"):
        np.testing.assert_array_equal(got.get(k).numpy(), np.asarray(want.get(k)), k)
    assert got.num_valid() == int(want.num_valid()) == 3 and len(got) == 5
    cat = Instances.cat([got, got[:2]])
    assert len(cat) == 7 and cat.num_valid() == 5 and cat.image_size == (50, 90)
    with pytest.raises(ValueError, match="leading dim"):
        got.scores = torch.zeros(4)
    with pytest.raises(ValueError, match="Cannot pad"):
        got.pad_to(3)


# ---------------------------------------------------------------- the model
def test_weights_bridge_both_ways(tiny):
    """load_from_jax raises on a key left over either way: the flax tree and
    the port hold the same parameters, Faster R-CNN's being Mask R-CNN's
    without the mask head."""
    _, params, _, port = tiny
    assert {k.split(".")[0] for k in port.state_dict()} == {"backbone", "fpn", "rpn", "roi_heads"}
    faster = GeneralizedRCNN(mask_on=False, **TINY)
    load_from_jax(faster, {**params, "roi_heads": {k: v for k, v in params["roi_heads"].items()
                                                   if not k.startswith("mask_")}})
    with pytest.raises(KeyError, match="not in the port"):
        load_from_jax(faster, params)


def test_fpn_matches_jax(tiny):
    images, _, stages, port = tiny
    with torch.no_grad():
        got = port._features(t(images))
    assert sorted(got) == sorted(stages[0]) == ["p2", "p3", "p4", "p5", "p6"]
    for k, want in stages[0].items():
        _close(got[k].permute(0, 2, 3, 1), want)
        assert got[k].shape[-2:] == want.shape[1:3], k


def test_rpn_matches_jax(tiny):
    """On JAX's FPN maps: logits and deltas at 2e-4 of their largest, anchors
    exact, the proposals (after the top-k, NMS and the top-k) at 1e-5 relative
    with their order."""
    _, _, stages, port = tiny
    feats = [_nchw(stages[0][f"p{i}"]) for i in range(2, 7)]
    proposals, anchors, logits, deltas = stages[1]
    with torch.no_grad():
        got = port.rpn(feats, torch.from_numpy(SIZES))
    np.testing.assert_array_equal(got[2].numpy(), anchors)
    _close(got[3], logits)
    _close(got[4], deltas)
    assert got[0].shape == proposals.shape == (2, TINY["proposals_per_image"], 4)
    np.testing.assert_allclose(got[0].numpy(), proposals, rtol=1e-5, atol=1e-4)


def test_roi_heads_match_jax(tiny):
    """On JAX's maps and proposals: class logits, box deltas and mask logits
    [B, R, 14, 14, C] at 2e-4 of their largest."""
    _, _, stages, port = tiny
    feats = {k: _nchw(v) for k, v in stages[0].items()}
    with torch.no_grad():
        got = port.roi_heads(feats, t(stages[1][0]))
    assert sorted(got) == sorted(stages[2])
    for k, want in stages[2].items():
        _close(got[k], want)
    assert got["mask_logits"].shape == (2, TINY["proposals_per_image"], 14, 14, TINY["num_classes"])


def _hold_detections(got, want, masks=True, exact_inputs=True):
    """Kept slots, classes and counts exact; boxes and scores at 1e-5 relative
    on JAX's own head outputs (``exact_inputs``), else at 2e-4 of their
    largest, as the convolutions before them."""
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    np.testing.assert_array_equal(got["classes"].numpy(), want["classes"])
    if exact_inputs:
        np.testing.assert_allclose(got["scores"].numpy(), want["scores"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=1e-5, atol=1e-4)
    else:
        _close(got["scores"], want["scores"])
        _close(got["boxes"], want["boxes"])
    assert want["valid"].sum() > 0, "the random weights must give detections"
    if masks:
        _close(got["mask_probs"], want["mask_probs"])


def test_detections_on_jax_heads_match_jax(tiny):
    """The fixed-shape fast_rcnn_inference on JAX's proposals and head outputs
    (the step whose top-k and NMS an f32 rounding upstream could flip):
    detections and their masks held as ``_hold_detections`` says."""
    _, _, stages, port = tiny
    proposals, head, want = t(stages[1][0]), {k: t(v) for k, v in stages[2].items()}, stages[3]
    probs = torch.softmax(head["cls_logits"], -1)[..., :-1]
    deltas = head["box_deltas"].reshape(2, -1, TINY["num_classes"], 4)
    boxes, scores, classes, valid, det_idx = port.detections(proposals, probs, deltas, torch.from_numpy(SIZES))
    got = {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid,
           "mask_probs": torch.sigmoid(port._class_masks(head["mask_logits"], det_idx, classes))}
    _hold_detections(got, want)


@pytest.mark.parametrize("mask_on", [True, False], ids=["mask_rcnn", "faster_rcnn"])
def test_inference_matches_jax(tiny, mask_on):
    """The whole ``inference`` from the images. Faster R-CNN's detections are
    Mask R-CNN's (the same tree without the mask head): the JAX mask model's."""
    images, params, stages, port = tiny
    model = port
    if not mask_on:
        model = GeneralizedRCNN(mask_on=False, **TINY).eval()
        load_from_jax(model, {**params, "roi_heads": {k: v for k, v in params["roi_heads"].items()
                                                      if not k.startswith("mask_")}})
    with torch.no_grad():
        got = model.inference(t(images), torch.from_numpy(SIZES))
    assert ("mask_probs" in got) == mask_on
    _hold_detections(got, stages[3], masks=mask_on, exact_inputs=False)
    with torch.no_grad():
        assert torch.equal(model(t(images), torch.from_numpy(SIZES))["boxes"], got["boxes"])


def test_masks_on_boxes_match_jax(tiny):
    images, _, stages, port = tiny
    with torch.no_grad():
        got = port.inference_masks_on_boxes(t(images), t(stages[3]["boxes"]),
                                            torch.from_numpy(stages[3]["classes"]).long())
    _close(got, stages[4])


def test_refusals_name_their_item(tiny):
    _, _, _, port = tiny
    with pytest.raises(NotImplementedError, match="item 11d"):
        GeneralizedRCNN(keypoint_on=True, **TINY)
    with pytest.raises(NotImplementedError, match="item 11d"):
        GeneralizedRCNN(cascade_on=True, **TINY)
    with pytest.raises(NotImplementedError, match="item 11d"):
        StandardROIHeads(32, 4, keypoint_on=True)
    # training is ported (tests/test_torch_rcnn_train.py holds it against JAX): the train-mode forward
    # returns the loss dict
    boxes = np.asarray([[[4, 6, 40, 30], [0, 0, 1e-4, 1e-4]]], np.float32)
    targets = DetTargets(torch.tensor([[1, 0]], dtype=torch.int32), t(boxes), torch.tensor([[True, False]]))
    masks = torch.zeros(1, 2, H, W, dtype=torch.bool)
    masks[0, 0, 6:30, 4:40] = True
    port.train()
    try:
        losses = port(torch.zeros(1, H, W, 3), torch.from_numpy(SIZES[:1]), targets, masks)
    finally:
        port.eval()
    assert list(losses) == ["loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask"]
    assert all(bool(torch.isfinite(v)) and v.requires_grad for v in losses.values())
