"""The rotated boxes in the port against the JAX package, on the CPU in f32:
``RotatedBoxes``, the exact rotated IoU, the rotated NMS, ROIAlignRotated,
``Box2BoxTransformRotated``, ``RROIHeads`` (outputs, inference, losses and
gradients) and ``RotatedCOCOEvaluator`` with ``build_evaluator``.

Tolerances (f32 on both sides): the IoU of each pair within 32 f32 ulps of
the largest squared coordinate over the pair's union (the clipped polygon's
area is a shoelace sum of products of coordinates near 20-60, ~3600 with an
ulp of 2.4e-4, which cancels to areas of 16-1000 and is summed in another
order, after sines and cosines that may differ in their last bit); the NMS
keep masks exactly (no two scores tie in the seeded sets: ties are a kept
divergence, the JAX package's host sort);
ROIAlignRotated at 1e-5 of the largest output; the deltas' round trip at
1e-4 (degrees) and 1e-5 relative; the heads' logits and deltas at 1e-5 of the
largest, the detections' kept slots and classes exactly and boxes / scores at
1e-4 of the largest; the losses at 1e-5 relative and each parameter's
gradient at 1e-4 of its norm; the evaluator's dict within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.evaluation.rotated_coco_eval import RotatedCOCOEvaluator as JaxRotatedCOCOEvaluator
from vnext_tpu.models.roi_heads_extra import Box2BoxTransformRotated as JaxB2B
from vnext_tpu.models.roi_heads_extra import RROIHeads as JaxRROIHeads
from vnext_tpu.ops.roi_align_rotated import roi_align_rotated as jax_roi_align_rotated
from vnext_tpu.ops.rotated_boxes import nms_rotated_mask as jax_nms_rotated
from vnext_tpu.ops.rotated_boxes import pairwise_iou_rotated as jax_iou_rotated
from vnext_tpu.ops.rotated_boxes import rotated_box_vertices as jax_vertices
from vnext_tpu.structures.boxes import RotatedBoxes as JaxRotatedBoxes
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.config import add_idol_config, get_cfg
from vnext_tpu_torch.data.catalog import MetadataCatalog
from vnext_tpu_torch.evaluation import RotatedCOCOEvaluator, build_evaluator
from vnext_tpu_torch.models import Box2BoxTransformRotated, RROIHeads
from vnext_tpu_torch.ops import nms_rotated_mask, pairwise_iou_rotated, roi_align_rotated
from vnext_tpu_torch.ops.rotated_boxes import rotated_box_vertices
from vnext_tpu_torch.structures import RotatedBoxes

from _torch_helpers import random_params, t

torch.set_num_threads(2)


def _boxes(rng, n, kind):
    """[n, 5] (cx, cy, w, h, angle) boxes of one kind of set."""
    cxcy = rng.uniform(20, 60, (n, 2))
    wh = rng.uniform(6, 30, (n, 2))
    if kind == "axis_aligned":
        a = np.zeros(n)
    elif kind == "deg45":
        a = np.full(n, 45.0)
    elif kind == "deg90":
        a = rng.choice([90.0, -90.0], n)
    elif kind == "disjoint":
        cxcy = np.stack([np.arange(n) * 40.0 + 20, np.full(n, 30.0)], 1)
        a = rng.uniform(-180, 180, n)
    elif kind == "nested":
        cxcy = np.tile([[40.0, 40.0]], (n, 1))
        wh = np.stack([np.linspace(4, 40, n)] * 2, 1)
        a = rng.uniform(-30, 30, n)
    else:
        a = rng.uniform(-180, 180, n)
    return np.concatenate([cxcy, wh, a[:, None]], 1).astype(np.float32)


_jit_iou = jax.jit(jax_iou_rotated)
_jit_nms = jax.jit(jax_nms_rotated)           # the threshold traced; an all-true ``valid`` is JAX's ``None``


def test_rotated_boxes_structure():
    rng = np.random.RandomState(0)
    arr = _boxes(rng, 6, "random")
    arr[:, 4] = [-540.0, -180.0, -10.0, 180.0, 200.0, 725.5]
    got, want = RotatedBoxes(t(arr)), JaxRotatedBoxes(jnp.asarray(arr))
    np.testing.assert_array_equal(got.normalize_angles().tensor.numpy(), np.asarray(want.normalize_angles().tensor))
    np.testing.assert_array_equal(got.area().numpy(), np.asarray(want.area()))
    assert len(got) == 6 and got[2].tensor.shape == (1, 5) and got[1:4].tensor.shape == (3, 5)
    assert len(RotatedBoxes.cat([got, got[0]])) == 7
    with pytest.raises(ValueError, match="N, 5"):
        RotatedBoxes(torch.zeros(3, 4))
    np.testing.assert_allclose(rotated_box_vertices(t(arr)).numpy(), np.asarray(jax_vertices(jnp.asarray(arr))),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["axis_aligned", "deg45", "deg90", "disjoint", "nested", "random"])
def test_pairwise_iou_rotated_matches_jax(kind):
    rng = np.random.RandomState(len(kind))
    a, b = _boxes(rng, 7, kind), _boxes(rng, 5, kind if kind != "disjoint" else "random")
    got = pairwise_iou_rotated(t(a), t(b)).numpy()
    want = np.asarray(_jit_iou(jnp.asarray(a), jnp.asarray(b)))
    area_a, area_b = a[:, 2] * a[:, 3], b[:, 2] * b[:, 3]
    union = area_a[:, None] + area_b[None] - want * (area_a[:, None] + area_b[None]) / (1 + want)
    coord = max(np.abs(a[:, :2]).max(), np.abs(b[:, :2]).max()) + max(a[:, 2:4].max(), b[:, 2:4].max())
    assert np.all(np.abs(got - want) <= 32 * np.finfo(np.float32).eps * coord ** 2 / union)
    assert np.any(want > 0.05) or kind == "disjoint"
    if kind == "nested":
        # the smallest box (4 x 4) inside the largest (40 x 40, the same centre): the IoU is the area ratio
        assert got[0, -1] == pytest.approx(16.0 / 1600.0, rel=1e-5)


def test_pairwise_iou_rotated_chunks(monkeypatch):
    """Chunked rows give the same matrix as one pass."""
    rng = np.random.RandomState(3)
    a, b = t(_boxes(rng, 11, "random")), t(_boxes(rng, 9, "random"))
    whole = pairwise_iou_rotated(a, b)
    from vnext_tpu_torch.ops import rotated_boxes

    monkeypatch.setattr(rotated_boxes, "PAIRS_PER_CHUNK", 20)
    torch.testing.assert_close(pairwise_iou_rotated(a, b), whole, rtol=0, atol=0)


@pytest.mark.parametrize("thresh", [0.1, 0.3, 0.7])
def test_nms_rotated_mask_matches_jax(thresh):
    rng = np.random.RandomState(int(thresh * 10))
    boxes = _boxes(rng, 24, "random")
    boxes[:, :2] = rng.uniform(30, 45, (24, 2))            # crowded, so that boxes overlap
    scores = rng.permutation(24).astype(np.float32) / 24 + 0.01
    valid = rng.rand(24) < 0.8
    for v in (None, valid):
        got = nms_rotated_mask(t(boxes), t(scores), thresh, valid=None if v is None else torch.from_numpy(v))
        want = _jit_nms(jnp.asarray(boxes), jnp.asarray(scores), thresh,
                        jnp.ones(24, bool) if v is None else jnp.asarray(v))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < 24


def test_roi_align_rotated_matches_jax():
    """Including ROIs that reach past the map (samples at <= -1 weigh 0; in
    (-1, 0) they clamp to the first row or column) and at spatial scale 1/4."""
    rng = np.random.RandomState(5)
    feat = rng.randn(2, 12, 16, 6).astype(np.float32)
    rois = np.concatenate([rng.randint(0, 2, (9, 1)), _boxes(rng, 9, "random")], 1).astype(np.float32)
    rois[0, 1:] = [1.0, 1.0, 60.0, 40.0, 30.0]            # mostly outside the map
    rois[1, 1:] = [0.2, 63.5, 8.0, 8.0, 0.0]              # at the left / bottom edges
    got = roi_align_rotated(t(feat).permute(0, 3, 1, 2), t(rois), (5, 4), spatial_scale=0.25, sampling_ratio=2)
    want = np.asarray(jax.jit(jax_roi_align_rotated, static_argnums=(2, 3, 4))(
        jnp.asarray(feat), jnp.asarray(rois), (5, 4), 0.25, 2))
    assert got.shape == want.shape == (9, 5, 4, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_box2box_transform_rotated_round_trip():
    rng = np.random.RandomState(6)
    src, tgt = _boxes(rng, 16, "random"), _boxes(rng, 16, "random")
    port, jx = Box2BoxTransformRotated(), JaxB2B()
    d = port.get_deltas(t(src), t(tgt))
    np.testing.assert_allclose(d.numpy(), np.asarray(jx.get_deltas(jnp.asarray(src), jnp.asarray(tgt))), rtol=1e-5,
                               atol=1e-5)
    back = port.apply_deltas(d, t(src)).numpy()
    np.testing.assert_allclose(back, np.asarray(jx.apply_deltas(jnp.asarray(d.numpy()), jnp.asarray(src))),
                               rtol=1e-5, atol=1e-4)
    wrapped = (tgt[:, 4] + 180.0) % 360.0 - 180.0
    np.testing.assert_allclose(back[:, :4], tgt[:, :4], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(back[:, 4], wrapped, rtol=0, atol=1e-4)
    assert np.all(back[:, 4] >= -180.0) and np.all(back[:, 4] < 180.0)


# ---------------------------------------------------------------- RROIHeads
B, R, C, FH, FW, NC, K = 2, 12, 8, 16, 20, 3, 4
HEAD = dict(num_classes=NC, pooler_size=7, fc_dim=32)


@pytest.fixture(scope="module")
def rroi():
    """A tiny RROIHeads in both packages on the same tree, features, ROIs and
    ground truth (ROIs near the ground truth, so that some are foreground)."""
    rng = np.random.RandomState(7)
    feat = rng.randn(B, FH, FW, C).astype(np.float32)
    gt = np.stack([_boxes(rng, K, "random") for _ in range(B)])
    gt[..., :2] = rng.uniform(15, 60, (B, K, 2))
    rois = np.repeat(gt, R // K, axis=1) + rng.randn(B, R, 5).astype(np.float32) * np.array([2, 2, 2, 2, 10],
                                                                                             np.float32)
    rois[..., 2:4] = np.abs(rois[..., 2:4]) + 2
    labels = rng.randint(0, NC, (B, K)).astype(np.int32)
    gvalid = np.array([[True, True, True, False], [True, True, False, False]])
    module = JaxRROIHeads(**HEAD)
    tree = random_params(lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(feat), jnp.asarray(rois), 0.25))
    port = RROIHeads(**HEAD, in_channels=C)
    load_from_jax(port, jax.tree.map(np.asarray, tree))
    return dict(feat=feat, rois=rois, gt=gt, labels=labels, gvalid=gvalid, module=module, tree=tree, port=port)


def test_rroi_heads_outputs_and_inference_match_jax(rroi):
    m, tree = rroi["module"], rroi["tree"]
    want = jax.jit(lambda p: m.apply({"params": p}, jnp.asarray(rroi["feat"]), jnp.asarray(rroi["rois"]), 0.25,
                                     train=False))(tree)
    with torch.no_grad():
        got = rroi["port"](t(rroi["feat"]).permute(0, 3, 1, 2), t(rroi["rois"]), 0.25, train=False)
    for k in ("cls_logits", "box_deltas"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert 0 < int(got["valid"].sum()) < B * R           # the NMS dropped some, kept some
    v = got["valid"].numpy()
    np.testing.assert_array_equal(got["classes"].numpy()[v], np.asarray(want["classes"])[v])
    for k in ("boxes", "scores"):
        w = np.asarray(want[k])[v]
        np.testing.assert_allclose(got[k].numpy()[v], w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_rroi_heads_losses_and_gradients_match_jax(rroi):
    m, tree, port = rroi["module"], rroi["tree"], rroi["port"]
    gt, labels, gvalid = (jnp.asarray(rroi[k]) for k in ("gt", "labels", "gvalid"))

    def loss(p):
        out = m.apply({"params": p}, jnp.asarray(rroi["feat"]), jnp.asarray(rroi["rois"]), 0.25)
        losses = JaxRROIHeads.losses(out["cls_logits"], out["box_deltas"], jnp.asarray(rroi["rois"]), gt, labels,
                                     gvalid, NC)
        return sum(losses.values()), losses

    (_, want), want_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(tree)
    port.zero_grad()
    out = port(t(rroi["feat"]).permute(0, 3, 1, 2), t(rroi["rois"]), 0.25)
    got = RROIHeads.losses(out["cls_logits"], out["box_deltas"], t(rroi["rois"]), t(rroi["gt"]),
                           torch.from_numpy(rroi["labels"]), torch.from_numpy(rroi["gvalid"]), NC)
    assert set(got) == set(want) == {"loss_cls_rotated", "loss_box_reg_rotated"}
    for k, v in want.items():
        assert float(got[k].detach()) == pytest.approx(float(v), rel=1e-5), k
    assert float(want["loss_box_reg_rotated"]) > 0          # some ROIs are foreground
    sum(got.values()).backward()
    want_g = params_from_jax(jax.tree.map(np.asarray, want_grads))
    for name, p in port.named_parameters():
        w = want_g[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-4 * np.linalg.norm(w) + 1e-9, err_msg=name)


# ---------------------------------------------------------------- RotatedCOCOEvaluator
def _rotated_records_and_outputs(seed):
    rng = np.random.RandomState(seed)
    records, outputs = [], []
    for img in range(4):
        gt = _boxes(rng, 5, "random")
        cls = rng.randint(0, 3, 5)
        records.append({"image_id": 100 + img,
                        "annotations": [{"category_id": int(c), "bbox": b.tolist()} for c, b in zip(cls, gt)]})
        # detections: the ground truth jittered (some close, some far), and a few strays
        det = np.concatenate([gt + rng.randn(5, 5).astype(np.float32) * np.array([1, 1, 1, 1, 8], np.float32)
                              * rng.choice([0.2, 1.0, 4.0], (5, 1)), _boxes(rng, 3, "random")])
        det_cls = np.concatenate([np.where(rng.rand(5) < 0.8, cls, (cls + 1) % 3), rng.randint(0, 3, 3)])
        scores = rng.rand(8).astype(np.float32)
        valid = rng.rand(8) < 0.9
        outputs.append({"boxes": det.astype(np.float32), "scores": scores, "classes": det_cls, "valid": valid})
    return records, outputs


@pytest.mark.parametrize("class_names", [None, ["plane", "ship", "car"]], ids=["plain", "by_class"])
def test_rotated_coco_evaluator_matches_jax(class_names):
    records, outputs = _rotated_records_and_outputs(11)
    got_ev, want_ev = RotatedCOCOEvaluator(class_names), JaxRotatedCOCOEvaluator(class_names)
    got_ev.reset()
    want_ev.reset()
    for r, o in zip(records, outputs):
        got_ev.process([r], [{k: torch.from_numpy(np.asarray(v)) for k, v in o.items()}])
        want_ev.process([r], [o])
    got, want = got_ev.evaluate(), want_ev.evaluate()
    assert got.keys() == want.keys() and got["bbox"].keys() == want["bbox"].keys()
    for k, v in want["bbox"].items():
        assert abs(got["bbox"][k] - v) <= 1e-12, k
    assert 0 < got["bbox"]["AP50"] < 100 and got["bbox"]["AP75"] <= got["bbox"]["AP50"]
    empty = RotatedCOCOEvaluator()
    assert empty.evaluate() == {"bbox": {"AP": 0.0, "AP50": 0.0, "AP75": 0.0}}


def test_build_evaluator_builds_rotated_coco(tmp_path):
    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.OUTPUT_DIR = str(tmp_path)
    MetadataCatalog.get("rotated_test_kind").set(evaluator_type="rotated_coco", thing_classes=["a", "b"])
    ev = build_evaluator(cfg, "rotated_test_kind")
    assert isinstance(ev, RotatedCOCOEvaluator) and ev._class_names == ["a", "b"]
