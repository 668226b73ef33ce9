"""The port's simOTA matcher, box ops, losses and set criterion against the JAX
package, on the CPU in f32.

The same seeded logits, boxes and padded targets go through both. The matching
outputs (``match`` and ``pos_neg_masks``) must be equal exactly, and are checked
first, so that a loss that differs points at the criterion. Each loss must then
agree within 1e-5 relative: the same f32 arithmetic, summed in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models import criterion as jcrit
from vnext_tpu.models import matcher as jmatch
from vnext_tpu.ops import losses as jlosses
from vnext_tpu.structures import boxes as jboxes
from vnext_tpu_torch.models import criterion as crit
from vnext_tpu_torch.models import matcher
from vnext_tpu_torch.ops import losses
from vnext_tpu_torch.structures import boxes

from _torch_helpers import t

torch.set_num_threads(2)

B, Q, K, C, N = 3, 40, 8, 5, 6     # frames, queries, gt slots, classes, instance slots
H4, W4 = 12, 16
TOL = 1e-5


def _case(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, Q, C) * 2.0).astype(np.float32)
    pred = np.concatenate([rng.rand(B, Q, 2) * 0.8 + 0.1, rng.rand(B, Q, 2) * 0.3 + 0.05], -1)
    gt = np.concatenate([rng.rand(B, K, 2) * 0.6 + 0.2, rng.rand(B, K, 2) * 0.3 + 0.1], -1)
    # a few predictions sit right on ground truth, as trained ones do
    pred[:, :K] = gt + rng.randn(B, K, 4) * 0.01
    valid = np.arange(K)[None] < np.asarray([[5], [0], [8]])         # one frame without objects
    labels = rng.randint(0, C, (B, K)).astype(np.int32)
    masks = rng.rand(B, K, H4, W4) > 0.6
    return dict(logits=logits, pred=pred.astype(np.float32), gt=gt.astype(np.float32),
                valid=valid, labels=labels, masks=masks)


def _targets(c, lib):
    if lib == "jax":
        return jcrit.Targets(jnp.asarray(c["labels"]), jnp.asarray(c["gt"]), jnp.asarray(c["masks"]),
                             jnp.asarray(c["valid"]), jnp.zeros((B, K), jnp.int32))
    return crit.Targets(torch.from_numpy(c["labels"]), t(c["gt"]), torch.from_numpy(c["masks"]),
                        torch.from_numpy(c["valid"]), torch.zeros(B, K, dtype=torch.int32))


@pytest.fixture(scope="module", params=[0, 1], ids=["seed0", "seed1"])
def matched(request):
    c = _case(request.param)
    want = jax.jit(jmatch.match)(jnp.asarray(c["logits"]), jnp.asarray(c["pred"]), jnp.asarray(c["labels"]),
                                 jnp.asarray(c["gt"]), jnp.asarray(c["valid"]))
    got = matcher.match(t(c["logits"]), t(c["pred"]), torch.from_numpy(c["labels"]), t(c["gt"]),
                        torch.from_numpy(c["valid"]))
    return c, got, want


def test_match_is_equal(matched):
    _, got, want = matched
    for name in matcher.MatchResult._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert got.selected_query.any()


def test_pos_neg_masks_are_equal(matched):
    c, _, _ = matched
    prob = 1 / (1 + np.exp(-c["logits"]))
    want = jax.jit(jax.vmap(jmatch.pos_neg_masks))(
        jnp.asarray(prob), jnp.asarray(c["pred"]), jnp.asarray(c["labels"]), jnp.asarray(c["gt"]),
        jnp.asarray(c["valid"]))
    got = matcher.pos_neg_masks(t(prob), t(c["pred"]), torch.from_numpy(c["labels"]), t(c["gt"]),
                                torch.from_numpy(c["valid"]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].any() and got[1].any()


def _rel(got, want):
    got, want = float(got), float(want)
    assert abs(got - want) <= TOL * max(abs(want), 1e-6), (got, want)


def test_label_and_box_losses(matched):
    c, got_m, want_m = matched
    _rel(crit.loss_labels(t(c["logits"]), got_m, _targets(c, "torch"), C),
         jcrit.loss_labels(jnp.asarray(c["logits"]), want_m, _targets(c, "jax"), C))
    got = crit.loss_boxes(t(c["pred"]), got_m, _targets(c, "torch"))
    want = jcrit.loss_boxes(jnp.asarray(c["pred"]), want_m, _targets(c, "jax"))
    assert set(got) == set(want) == {"loss_bbox", "loss_giou"}
    for k in got:
        _rel(got[k], want[k])


def test_mask_losses(matched):
    c, got_m, want_m = matched
    rng = np.random.RandomState(2)
    mask_logits = (rng.randn(B, N, H4, W4) * 2).astype(np.float32)
    order = np.argsort(-np.asarray(want_m.selected_query, np.float32), axis=1, kind="stable")[:, :N]
    inst_valid = np.take_along_axis(np.asarray(want_m.selected_query), order, 1)
    inst_gt = np.take_along_axis(np.asarray(want_m.gt_index), order, 1)
    got = crit.loss_masks(t(mask_logits), torch.from_numpy(inst_gt).long(), torch.from_numpy(inst_valid),
                          _targets(c, "torch"))
    want = jcrit.loss_masks(jnp.asarray(mask_logits), jnp.asarray(inst_gt), jnp.asarray(inst_valid),
                            _targets(c, "jax"))
    assert set(got) == set(want) == {"loss_mask", "loss_dice"}
    for k in got:
        _rel(got[k], want[k])


def test_reid_losses(matched):
    c, got_m, want_m = matched
    rng = np.random.RandomState(3)
    key_e, ref_e = (rng.randn(B, Q, 16).astype(np.float32) for _ in range(2))
    prob = 1 / (1 + np.exp(-c["logits"]))
    pos, neg = jax.vmap(jmatch.pos_neg_masks)(jnp.asarray(prob), jnp.asarray(c["pred"]), jnp.asarray(c["labels"]),
                                             jnp.asarray(c["gt"]), jnp.asarray(c["valid"]))
    want = jcrit.loss_reid(jnp.asarray(key_e), jnp.asarray(ref_e), want_m.matched_query_per_gt, pos, neg,
                           jnp.asarray(c["valid"]))
    got = crit.loss_reid(t(key_e), t(ref_e), got_m.matched_query_per_gt, torch.from_numpy(np.asarray(pos)),
                         torch.from_numpy(np.asarray(neg)), torch.from_numpy(c["valid"]))
    assert set(got) == set(want) == {"loss_reid", "loss_reid_aux"}
    for k in got:
        _rel(got[k], want[k])


def test_reid_gradient_is_finite_without_positives(matched):
    """A gt with no positive query masks every term of one log-sum-exp; the
    gradient must stay finite (the masked rows get zero)."""
    c, got_m, _ = matched
    key_e = t(np.random.RandomState(4).randn(B, Q, 16)).requires_grad_()
    pos = torch.zeros(B, K, Q, dtype=torch.bool)
    neg = torch.ones(B, K, Q, dtype=torch.bool)
    out = crit.loss_reid(key_e, key_e * 0.5, got_m.matched_query_per_gt, pos, neg, torch.from_numpy(c["valid"]))
    sum(out.values()).backward()
    assert torch.isfinite(key_e.grad).all()


def test_weight_dict_matches():
    assert crit.default_weight_dict(dec_layers=6) == jcrit.default_weight_dict(dec_layers=6)


@pytest.mark.parametrize("fn", ["pairwise_iou", "generalized_box_iou"])
def test_pairwise_box_ops(fn):
    rng = np.random.RandomState(5)
    a, b = (np.concatenate([rng.rand(n, 2) * 0.5, rng.rand(n, 2) * 0.5 + 0.5], -1).astype(np.float32)
            for n in (7, 5))                                          # xyxy
    got = getattr(boxes, fn)(t(a), t(b)).numpy()
    want = np.asarray(getattr(jboxes, fn)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    batched = getattr(boxes, fn)(t(np.stack([a, a])), t(np.stack([b, b]))).numpy()
    np.testing.assert_array_equal(batched[1], got)


def test_elementwise_losses():
    rng = np.random.RandomState(6)
    x = (rng.randn(4, 50) * 3).astype(np.float32)
    y = (rng.rand(4, 50) > 0.5).astype(np.float32)
    valid = np.asarray([True, False, True, True])
    np.testing.assert_allclose(losses.sigmoid_bce_with_logits(t(x), t(y)).numpy(),
                               np.asarray(jlosses.sigmoid_bce_with_logits(jnp.asarray(x), jnp.asarray(y))),
                               atol=1e-6, rtol=0)
    _rel(losses.sigmoid_focal_loss(t(x), t(y), 3.0, valid=torch.from_numpy(valid)),
         jlosses.sigmoid_focal_loss(jnp.asarray(x), jnp.asarray(y), 3.0, valid=jnp.asarray(valid)))
    _rel(losses.dice_loss(t(x), t(y), 3.0, valid=torch.from_numpy(valid)),
         jlosses.dice_loss(jnp.asarray(x), jnp.asarray(y), 3.0, valid=jnp.asarray(valid)))
    bx = np.concatenate([rng.rand(6, 2) * 0.5, rng.rand(6, 2) * 0.5 + 0.5], -1).astype(np.float32)
    by = np.concatenate([rng.rand(6, 2) * 0.5, rng.rand(6, 2) * 0.5 + 0.5], -1).astype(np.float32)
    np.testing.assert_allclose(boxes.elementwise_giou_loss(t(bx), t(by)).numpy(),
                               np.asarray(jboxes.elementwise_giou_loss(jnp.asarray(bx), jnp.asarray(by))),
                               atol=1e-6, rtol=0)
