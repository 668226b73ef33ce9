"""RetinaNet and FCOS in the port against the JAX package, on the CPU in f32.

Each model is tiny (ResNet-18, FPN 32 channels, 4 classes, two images at
64x96 with 6 ground-truth slots of which 3 and 2 hold objects), built once
from a random flax tree (``random_params``: no init is compiled) and carried
across by ``load_from_jax``. One jitted JAX function per model returns the
head's flattened outputs, the anchors (RetinaNet) or points, strides and size
ranges (FCOS), the matcher's or ``_assign``'s outputs, the losses, every
parameter's gradient and the inference's detections.

Tolerances (f32 on both sides, the convolutions' sums in other orders, as
tests/test_torch_rcnn_train.py holds R-CNN): the head's outputs at 1e-4 of
their largest; anchors, points and every discrete choice (matches, labels,
assignments, foreground, kept sets and classes) exactly equal; the losses at
1e-4 relative; every gradient at 1e-4 of its norm plus a floor of 1e-6 of the
global norm; the detections' boxes and scores at 1e-4 of their largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.dense_heads import iou_matcher as jax_iou_matcher
from vnext_tpu.models.fcos import FCOS as JaxFCOS
from vnext_tpu.models.retinanet import DetTargets as JaxDetTargets
from vnext_tpu.models.retinanet import RetinaNet as JaxRetinaNet
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.models.fcos import FCOS
from vnext_tpu_torch.models.rcnn import DetTargets
from vnext_tpu_torch.models.retinanet import RetinaNet

from _torch_helpers import random_params, t

torch.set_num_threads(2)

H, W, K = 64, 96, 6
TINY = dict(num_classes=4, backbone_depth=18, fpn_channels=32, test_score_thresh=0.5)
# with the threshold above and these counts (of 387 anchors and 129 points) some candidates fall below the
# threshold or are suppressed, so that the kept set is a choice (at the defaults all of the top 100 are kept)
DETECTIONS = {"retinanet": 300, "fcos": 120}
TOL, GRAD_FLOOR = 1e-4, 1e-6


def _targets(seed):
    """Boxes of 3 and 2 objects (the rest padded as the mapper pads them),
    labels and validity."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((2, K, 4), np.float32)
    boxes[..., 2:] = 1e-4
    labels = np.zeros((2, K), np.int32)
    valid = np.zeros((2, K), bool)
    for b, n in enumerate((3, 2)):
        for k in range(n):
            x1, y1 = rng.uniform(0, W - 40), rng.uniform(0, H - 32)
            boxes[b, k] = x1, y1, x1 + rng.uniform(12, 40), y1 + rng.uniform(10, 32)
            labels[b, k] = rng.randint(0, TINY["num_classes"])
            valid[b, k] = True
    return labels, boxes, valid


def _by_name(tree):
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _jax_side(name, m, images, targets):
    """Inside ``apply``: the flattened head outputs, the geometry, the
    matcher's or ``_assign``'s outputs."""
    feats = m._features(images)
    b, c = images.shape[0], m.num_classes
    if name == "retinanet":
        logits_l, deltas_l = m.head(feats)
        anchors = m._anchors(feats)
        match = jax.vmap(lambda g, v: jax_iou_matcher(g, v, anchors, m.iou_thresholds))(targets.boxes, targets.valid)
        return dict(logits=jnp.concatenate([x.reshape(b, -1, c) for x in logits_l], 1),
                    deltas=jnp.concatenate([x.reshape(b, -1, 4) for x in deltas_l], 1),
                    anchors=anchors, matched=match[0], labels=match[1])
    logits_l, regs_l, ctrs_l = m.head(feats)
    points, strides, ranges = m._points(feats)
    matched, fg, reg = jax.vmap(lambda gb, gl, gv: m._assign(points, strides, ranges, gb, gl, gv))(
        targets.boxes, targets.labels, targets.valid)
    return dict(logits=jnp.concatenate([x.reshape(b, -1, c) for x in logits_l], 1),
                regs=jnp.concatenate([x.reshape(b, -1, 4) for x in regs_l], 1),
                ctrs=jnp.concatenate([x.reshape(b, -1) for x in ctrs_l], 1),
                points=points, strides=strides, ranges=ranges, matched=matched, fg=fg, reg=reg)


MODELS = {"retinanet": (JaxRetinaNet, RetinaNet), "fcos": (JaxFCOS, FCOS)}
LOSS_KEYS = {"retinanet": ["loss_cls", "loss_box_reg"], "fcos": ["loss_fcos_cls", "loss_fcos_loc", "loss_fcos_ctr"]}


@pytest.fixture(scope="module", params=list(MODELS))
def tiny(request):
    name = request.param
    jax_cls, port_cls = MODELS[name]
    rng = np.random.RandomState(0)
    images = rng.randn(2, H, W, 3).astype(np.float32)
    labels, boxes, valid = _targets(1)
    kwargs = dict(TINY, max_detections=DETECTIONS[name])
    jmodel = jax_cls(**kwargs)
    jt = JaxDetTargets(labels=jnp.asarray(labels), boxes=jnp.asarray(boxes), valid=jnp.asarray(valid))
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images), jt), seed=7)

    def run(p, images, targets):
        inner = jmodel.apply({"params": p}, images, targets, method=lambda m, x, tg: _jax_side(name, m, x, tg))
        out, vjp = jax.vjp(lambda q: jmodel.apply({"params": q}, images, targets), p)
        grads = vjp({k: jnp.ones_like(v) for k, v in out.items()})[0]
        det = jmodel.apply({"params": p}, images, method=jax_cls.inference)
        return inner, out, grads, det

    inner, losses, grads, det = jax.jit(run)(params, jnp.asarray(images), jt)
    want = dict(inner=jax.tree.map(np.asarray, inner), losses={k: float(v) for k, v in losses.items()},
                grads=_by_name(grads), det=jax.tree.map(np.asarray, det))

    port = port_cls(**kwargs).train()
    load_from_jax(port, params)
    targets = DetTargets(*(torch.from_numpy(a) for a in (labels, boxes, valid)))
    outputs = port._outputs(t(images))
    got_losses = port.losses(*outputs, targets)
    sum(got_losses.values()).backward()
    port.eval()
    with torch.no_grad():
        det = port(t(images))
    return dict(name=name, want=want, port=port, outputs=[o.detach() for o in outputs], targets=targets,
                losses={k: float(v.detach()) for k, v in got_losses.items()},
                det={k: v.numpy() for k, v in det.items()})


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def test_heads_and_geometry_match_jax(tiny):
    """The head's flattened outputs at 1e-4 of their largest; the anchors, or
    the points, strides and size ranges, exactly."""
    w, out = tiny["want"]["inner"], tiny["outputs"]
    _close(out[0], w["logits"])
    if tiny["name"] == "retinanet":
        _close(out[1], w["deltas"])
        assert out[2].shape == (3 * sum(-(-H // s) * -(-W // s) for s in (8, 16, 32, 64, 128)), 4)
        np.testing.assert_array_equal(out[2].numpy(), w["anchors"])
    else:
        _close(out[1], w["regs"])
        _close(out[2], w["ctrs"])
        assert float(out[1].min()) == 0.0 and float(out[1].max()) > 0      # relu(box_out x scale)
        for got, key in zip(out[3:], ("points", "strides", "ranges")):
            np.testing.assert_array_equal(got.numpy(), w[key])


def test_matching_equals_jax(tiny):
    """The IoU matcher's slots and labels (RetinaNet), ``_assign``'s slots,
    foreground and distances (FCOS), on the same anchors or points."""
    w, port, out, targets = tiny["want"]["inner"], tiny["port"], tiny["outputs"], tiny["targets"]
    if tiny["name"] == "retinanet":
        matched, labels = port.match(out[2], targets)
        np.testing.assert_array_equal(matched.numpy(), w["matched"])
        np.testing.assert_array_equal(labels.numpy(), w["labels"])
        assert int((labels == 1).sum()) > 0 and int((labels == -1).sum()) > 0
    else:
        matched, fg, reg = port.match(*out[3:], targets)
        np.testing.assert_array_equal(matched.numpy(), w["matched"])
        np.testing.assert_array_equal(fg.numpy(), w["fg"])
        np.testing.assert_array_equal(reg.numpy(), w["reg"])
        assert int(fg.sum()) > 0 and int(matched[fg].max()) > 0      # some points take a slot past the first


def test_losses_match_jax(tiny):
    want, got = tiny["want"]["losses"], tiny["losses"]
    assert list(got) == LOSS_KEYS[tiny["name"]] and set(got) == set(want)     # JAX's order (jit sorts its dict)
    for k, v in want.items():
        assert abs(got[k] - v) <= TOL * abs(v), (k, got[k], v)


def test_every_gradient_matches_jax(tiny):
    want, port = tiny["want"]["grads"], tiny["port"]
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(got) == set(want)
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want.values()))
    errs = {n: np.linalg.norm(g - want[n]) / (TOL * np.linalg.norm(want[n]) + GRAD_FLOOR * norm)
            for n, g in got.items()}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert worst[0][1] <= 1.0, worst
    assert np.linalg.norm(want["head.cls_score.weight"]) > 0
    if tiny["name"] == "fcos":
        assert np.abs(got["head.scales"]).max() > 0


def test_inference_matches_jax(tiny):
    """The detections: the kept set and the classes exactly, the boxes and
    scores at 1e-4 of their largest."""
    want, got = tiny["want"]["det"], tiny["det"]
    assert sorted(got) == ["boxes", "classes", "scores", "valid"]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum() > 0 and (~got["valid"]).sum() > 0, got["valid"].sum(1)
    np.testing.assert_array_equal(got["classes"], want["classes"])
    _close(got["scores"], want["scores"])
    _close(got["boxes"], want["boxes"])
