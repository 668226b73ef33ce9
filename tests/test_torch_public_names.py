"""The port's counterparts of the JAX package's remaining public names, on the CPU in f32.

Each case runs the same numpy inputs (and, for a module with parameters, the
same flax tree through ``checkpoint/from_jax.py``) through the JAX function
and the port's, the JAX side under one ``jax.jit`` where it is array code:

- ``structures/masks.py``: ``BitMasks`` (``nonempty``, ``get_bounding_boxes``,
  ``cat``, indexing), ``PolygonMasks`` (boxes, ``crop_and_resize``, ``area``,
  ``cat``, indexing), ``polygon_area``, ``rasterize_polygons_within_box``,
  ``ROIMasks.to_bitmasks`` and ``mask_iou_pairwise``: equal, bit for bit
  where the JAX result is boolean;
- ``models/layers.py``: ``ASPP`` (NHWC) and ``SyncBatchNorm`` with no process
  group (outputs and the running statistics), at 1e-5;
  tests/test_torch_distributed.py holds it across two processes;
- ``ops``: ``diou_loss``, ``ciou_loss``, ``calculate_uncertainty`` and
  ``resize_bilinear_ac`` at 1e-6;
- ``build_swin_backbone`` on configs/idol/ytvis19_swinL.yaml: the port's
  parameter names and shapes are the JAX tree's (by ``jax.eval_shape``),
  bridged; nothing runs at full width;
- ``utils/logger.py``'s ``log_first_n`` / ``log_every_n`` /
  ``log_every_n_seconds`` emit the same records, and ``setup_logger`` of a
  process of rank 1 writes ``log.txt.rank1`` and prints nothing;
- ``utils/events.py``: ``has_event_storage``, and ``TensorboardWriter``'s
  no-op where ``torch.utils.tensorboard`` cannot be imported;
- ``utils/analysis.find_unused_parameters`` names the same parameters as
  JAX's on a module with a dead branch;
- ``evaluation/native.rle_intersection_union_native`` equals the evaluator's
  Python run merge.
"""

import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models import layers as jax_layers
from vnext_tpu.ops import interpolate as jax_interp
from vnext_tpu.ops import losses as jax_losses
from vnext_tpu.ops import point_sample as jax_ps
from vnext_tpu.structures import masks as jax_masks
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.models import layers
from vnext_tpu_torch.ops import interpolate, losses, point_sample
from vnext_tpu_torch.structures import masks

from _torch_helpers import random_params, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5       # a module's chain of f32 operations, sums in other orders
TOL_OP = 1e-6    # one elementwise formula or one separable product


def _mask_stack(seed, n=6, h=20, w=30):
    rng = np.random.RandomState(seed)
    m = np.zeros((n, h, w), bool)
    for i in range(n - 1):                      # the last one stays empty
        y0, x0 = rng.randint(0, h - 4), rng.randint(0, w - 4)
        m[i, y0:y0 + rng.randint(2, h - y0), x0:x0 + rng.randint(2, w - x0)] = True
        m[i] &= rng.rand(h, w) < 0.8
    return m


def test_bitmasks_and_mask_iou_match_jax():
    a, b = _mask_stack(0), _mask_stack(1, n=4)

    @jax.jit
    def ref(a, b):
        bm = jax_masks.BitMasks(a)
        cat = jax_masks.BitMasks.cat([bm, jax_masks.BitMasks(b)])
        return (bm.nonempty(), bm.get_bounding_boxes(), cat[2:7].get_bounding_boxes(), bm[3].tensor,
                jax_masks.mask_iou_pairwise(a, b))

    want = [np.asarray(x) for x in ref(a, b)]
    bm = masks.BitMasks(torch.from_numpy(a))
    cat = masks.BitMasks.cat([bm, masks.BitMasks(torch.from_numpy(b))])
    got = [bm.nonempty(), bm.get_bounding_boxes(), cat[2:7].get_bounding_boxes(), bm[3].tensor,
           masks.mask_iou_pairwise(torch.from_numpy(a), torch.from_numpy(b))]
    assert bm.device == torch.device("cpu") and len(cat) == 10 and cat.image_size == (20, 30)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert not want[0][-1] and (want[1][-1] == 0).all()


def _polygons(seed, n=4):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        parts = []
        for _ in range(rng.randint(1, 3)):
            c = rng.rand(2) * 40 + 10
            k = rng.randint(3, 7)
            ang = np.sort(rng.rand(k)) * 2 * np.pi
            r = rng.rand(k) * 8 + 2
            parts.append(np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], -1).reshape(-1))
        out.append(parts)
    return out


def test_polygon_masks_match_jax():
    polys, more = _polygons(2), _polygons(3, n=2)
    jpm, pm = jax_masks.PolygonMasks(polys), masks.PolygonMasks(polys)
    boxes = jpm.get_bounding_boxes()
    np.testing.assert_array_equal(pm.get_bounding_boxes(), boxes)
    np.testing.assert_array_equal(pm.area(), jpm.area())
    np.testing.assert_array_equal(pm.nonempty(), jpm.nonempty())
    np.testing.assert_array_equal(pm.crop_and_resize(boxes, 14), jpm.crop_and_resize(boxes, 14))
    jcat = jax_masks.PolygonMasks.cat([jpm, jax_masks.PolygonMasks(more)])
    cat = masks.PolygonMasks.cat([pm, masks.PolygonMasks(more)])
    for item in (1, slice(1, 5), [0, 4], np.array([True, False, True, False, False, True])):
        np.testing.assert_array_equal(cat[item].get_bounding_boxes(), jcat[item].get_bounding_boxes())
    x, y = polys[0][0][0::2], polys[0][0][1::2]
    assert masks.polygon_area(x, y) == jax_masks.polygon_area(x, y)
    box = np.array([5.0, 7.5, 40.0, 33.0])
    np.testing.assert_array_equal(masks.rasterize_polygons_within_box(polys[1], box, 28),
                                  jax_masks.rasterize_polygons_within_box(polys[1], box, 28))
    np.testing.assert_array_equal(masks.BitMasks.from_polygon_masks(pm, 64, 60).tensor.numpy(),
                                  np.asarray(jax_masks.BitMasks.from_polygon_masks(jpm, 64, 60).tensor))


def test_roi_masks_to_bitmasks_match_jax():
    rng = np.random.RandomState(4)
    probs = rng.rand(5, 28, 28).astype(np.float32)
    xy = rng.rand(5, 2) * 50
    boxes = np.concatenate([xy, xy + rng.rand(5, 2) * 30 + 4], 1).astype(np.float32)
    want = jax.jit(lambda m, b: jax_masks.ROIMasks(m).to_bitmasks(b, 70, 90).tensor)(probs, boxes)
    got = masks.ROIMasks(torch.from_numpy(probs))[1:].to_bitmasks(torch.from_numpy(boxes[1:]), 70, 90)
    assert got.tensor.dtype == torch.bool
    np.testing.assert_array_equal(got.tensor.numpy(), np.asarray(want)[1:])


def test_aspp_matches_jax():
    x = np.random.RandomState(5).randn(2, 9, 11, 16).astype(np.float32)
    jm = jax_layers.ASPP(out_channels=8, dilations=(1, 2, 3))
    params = random_params(lambda: jm.init(jax.random.PRNGKey(0), x), seed=5)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, x))
    port = layers.ASPP(16, 8, dilations=(1, 2, 3))
    load_from_jax(port, params)
    got = port(t(x)).detach().numpy()
    assert got.shape == want.shape == (2, 9, 11, 8)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_running_average", [False, True])
def test_sync_batch_norm_without_a_group_matches_jax(use_running_average):
    rng = np.random.RandomState(6)
    x = (rng.randn(4, 5, 6, 3) * 2 + 1).astype(np.float32)                  # NHWC, as flax
    jm = jax_layers.SyncBatchNorm(features=3)
    variables = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), x))()
    params = {"bn": {"scale": (1 + 0.1 * rng.randn(3)).astype(np.float32),
                     "bias": (0.1 * rng.randn(3)).astype(np.float32)}}
    stats = {"bn": {"mean": (0.1 * rng.randn(3)).astype(np.float32),
                    "var": (1 + rng.rand(3)).astype(np.float32)}}
    assert jax.tree.map(np.shape, variables["params"]) == jax.tree.map(np.shape, params)

    @jax.jit
    def ref(p, s, x):
        return jm.apply({"params": p, "batch_stats": s}, x, use_running_average=use_running_average,
                        mutable=["batch_stats"])

    y, new = ref(params, stats, x)
    port = layers.SyncBatchNorm(3)
    load_from_jax(port, {"bn": {**params["bn"], **stats["bn"]}})        # batch_stats carry across as buffers
    got = port(t(np.moveaxis(x, -1, 1)), use_running_average=use_running_average)
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1), np.asarray(y), rtol=TOL, atol=TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(port.bn, k).numpy(), np.asarray(new["batch_stats"]["bn"][k]),
                                   rtol=TOL, atol=TOL)


def test_box_losses_uncertainty_and_resize_match_jax():
    rng = np.random.RandomState(7)
    xy = rng.rand(2, 50, 2) * 40
    b1 = np.concatenate([xy[0], xy[0] + rng.rand(50, 2) * 20 + 1], -1).astype(np.float32)
    b2 = np.concatenate([xy[1], xy[1] + rng.rand(50, 2) * 20 + 1], -1).astype(np.float32)
    logits = rng.randn(3, 7, 9).astype(np.float32)
    img = rng.randn(2, 3, 7, 9).astype(np.float32)

    @jax.jit
    def ref(b1, b2, logits, img):
        ciou_grad = jax.grad(lambda b: jax_losses.ciou_loss(b, b2).sum())(b1)
        return (jax_losses.diou_loss(b1, b2), jax_losses.ciou_loss(b1, b2), ciou_grad,
                jax_ps.calculate_uncertainty(logits), jax_interp.resize_bilinear_ac(img, 13, 20),
                jax_interp.resize_bilinear_ac(img, 4, 1))

    want = [np.asarray(v) for v in ref(b1, b2, logits, img)]
    tb1 = t(b1).requires_grad_()
    ciou = losses.ciou_loss(tb1, t(b2))
    ciou.sum().backward()
    got = [losses.diou_loss(t(b1), t(b2)), ciou, tb1.grad, point_sample.calculate_uncertainty(t(logits)),
           interpolate.resize_bilinear_ac(t(img), 13, 20), interpolate.resize_bilinear_ac(t(img), 4, 1)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=TOL_OP, atol=TOL_OP)


def _bridged_shapes(tree, prefix=""):
    """{port name: shape} of a flax tree of shapes, by ``checkpoint/from_jax.py``'s rules."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_bridged_shapes(v, f"{prefix}{k}."))
            continue
        shape = tuple(v.shape)
        if k == "kernel":
            perm = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[len(shape)]
            shape, k = tuple(shape[i] for i in perm), "weight"
        elif k == "scale":
            k = "weight"
        out[prefix + k] = shape
    return out


def test_build_swin_backbone_tree_matches_jax():
    from vnext_tpu.config import add_idol_config as jax_add_idol_config
    from vnext_tpu.config import get_cfg as jax_get_cfg
    from vnext_tpu.models.backbones.swin import build_swin_backbone as jax_build
    from vnext_tpu_torch.config import add_idol_config, get_cfg
    from vnext_tpu_torch.models.backbones.swin import build_swin_backbone

    path = os.path.join(REPO, "configs", "idol", "ytvis19_swinL.yaml")
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jax_add_idol_config(jcfg)
    add_idol_config(cfg)
    jcfg.merge_from_file(path)
    cfg.merge_from_file(path)
    jm = jax_build(jcfg)
    x = jnp.zeros((1, 96, 96, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))["params"]
    with torch.device("meta"):
        port = build_swin_backbone(cfg)
    assert {k: tuple(p.shape) for k, p in port.named_parameters()} == _bridged_shapes(shapes)
    s = cfg.MODEL.SWIN
    assert (port.embed_dim, port.depths, port.patch_size, port.drop_path_rate) == (192, (2, 2, 18, 2), 4, 0.3)
    assert (s.MLP_RATIO, s.QKV_BIAS, s.QK_SCALE, s.PATCH_NORM) == (jm.mlp_ratio, jm.qkv_bias, jm.qk_scale,
                                                                   jm.patch_norm)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _emit(module, name):
    handler = _Records()
    logger = logging.getLogger(name)
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        for i in range(5):
            module.log_first_n(logging.INFO, "first two", n=2, name=name)
            module.log_first_n(logging.INFO, "once by message", n=1, name=name, key="message")
            module.log_every_n(logging.INFO, f"every third {i}", n=3, name=name)
            module.log_every_n_seconds(logging.INFO, f"hourly {i}", n=3600, name=name)
    finally:
        logger.removeHandler(handler)
    return handler.messages


def test_log_helpers_emit_what_jax_emits():
    from vnext_tpu.utils import logger as jax_logger
    from vnext_tpu_torch.utils import logger

    got = _emit(logger, "test_public_names.port")
    assert got == _emit(jax_logger, "test_public_names.jax")
    assert got == ["first two", "once by message", "every third 0", "hourly 0", "first two", "every third 3"]


def test_setup_logger_of_rank_one_writes_its_own_file(tmp_path):
    from vnext_tpu_torch.utils.logger import setup_logger

    name = "test_public_names.rank1"
    log = setup_logger(str(tmp_path), name=name, process_rank=1)
    try:
        log.info("from rank one")
        assert not any(type(h) is logging.StreamHandler for h in log.handlers)
        for h in log.handlers:
            h.flush()
        assert os.listdir(tmp_path) == ["log.txt.rank1"]
        assert "from rank one" in (tmp_path / "log.txt.rank1").read_text()
    finally:
        for h in list(log.handlers):
            log.removeHandler(h)
            h.close()


def test_has_event_storage_and_tensorboard_no_op(monkeypatch, tmp_path):
    from vnext_tpu.utils import events as jax_events
    from vnext_tpu_torch.utils import events

    for mod in (jax_events, events):
        assert not mod.has_event_storage()
        with mod.EventStorage():
            assert mod.has_event_storage()
        assert not mod.has_event_storage()
    # where torch.utils.tensorboard cannot be imported, both writers are no-ops
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for mod in (jax_events, events):
        writer = mod.TensorboardWriter(str(tmp_path / mod.__name__))
        with mod.EventStorage():
            mod.get_event_storage().put_scalar("loss", 1.0)
            writer.write()
        writer.close()
        assert writer._writer is None
    assert os.listdir(tmp_path) == []


def test_find_unused_parameters_names_what_jax_names():
    import flax.linen as fnn
    from vnext_tpu.utils.analysis import find_unused_parameters as jax_find
    from vnext_tpu_torch.utils.analysis import find_unused_parameters

    class Dead(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            live = fnn.Dense(4, name="live")(x)
            dead = fnn.Dense(4, name="dead")(x)
            return {"out": live.sum() + jax.lax.stop_gradient(dead).sum()}

    class PortDead(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.live = layers.Dense(3, 4)
            self.dead = layers.Dense(3, 4)

        def forward(self, x):
            return {"out": self.live(x).sum() + self.dead(x).detach().sum()}

    x = np.random.RandomState(8).randn(2, 3).astype(np.float32)
    jm = Dead()
    params = random_params(lambda: jm.init(jax.random.PRNGKey(0), x), seed=8)
    want = jax_find(lambda p, x: jm.apply({"params": p}, x), params, x)
    port = PortDead()
    load_from_jax(port, params)
    got = find_unused_parameters(port, lambda m, x: m(x), t(x))
    assert sorted(got) == sorted(want) == ["['dead']['bias']", "['dead']['kernel']"]


def test_rle_intersection_union_native_matches_the_python_merge():
    from vnext_tpu_torch.evaluation import native
    from vnext_tpu_torch.evaluation.rle import rle_counts, rle_encode
    from vnext_tpu_torch.evaluation.ytvos_eval import _rle_intersection_union

    if not native.available():
        pytest.skip("no C compiler: the native library cannot be built")
    a, b = _mask_stack(9, n=3, h=33, w=41), _mask_stack(10, n=3, h=33, w=41)
    for ma in a:
        for mb in b:
            ra, rb = rle_encode(ma), rle_encode(mb)
            got = native.rle_intersection_union_native(rle_counts(ra), rle_counts(rb))
            assert got == _rle_intersection_union(ra, rb)
            assert got == (float((ma & mb).sum()), float((ma | mb).sum()))
