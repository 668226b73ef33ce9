"""The port's MaskFormer train forward against the JAX package's, on the CPU in f32.

A tiny MaskFormer (ResNet-18, hidden 32, 8 queries, 1 encoder and 2 decoder
layers, FFN 64; the JAX package on its jnp MSDA path) gets one random flax
tree of ``MaskFormer.init`` for ``__call__``, which the weight bridge loads into
the port. Two frames with 2 and 3 of 4 instance slots valid go through both
at ``TRAIN_NUM_POINTS 0`` (the dense mask losses: the point draws differ
between the frameworks; ``tests/test_torch_point_sample.py`` holds the
sampled losses at JAX's coordinates):

- ``maskformer_match_cost`` on random predictions within 1e-5;
- the loss dict (``loss_ce``, ``loss_mask``, ``loss_dice`` and the ``_0`` /
  ``_1`` terms of the two predictions before the last) and every parameter's
  gradient of the weighted total, at ``tests/test_torch_train_step.py``'s
  tolerances;
- ground truth with no valid slot: finite losses, JAX's again;
- ``maskformer_weight_dict`` of configs/minvis/ovis_r50.yaml equals JAX's.

The JAX side is one ``jit`` of ``value_and_grad``, shared by the cases.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.mask2former import MaskFormer as JaxMaskFormer
from vnext_tpu.models.mask2former import MaskTargets as JaxMaskTargets
from vnext_tpu.models.mask2former import maskformer_match_cost as jax_match_cost
from vnext_tpu.models.mask2former import maskformer_weight_dict as jax_weight_dict
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.config import add_maskformer_config, get_cfg
from vnext_tpu_torch.models.mask2former import (MaskFormer, MaskTargets, maskformer_match_cost,
                                                maskformer_weight_dict)

from _torch_helpers import random_params

H, W, K = 64, 96, 4
TINY = dict(num_classes=5, hidden_dim=32, num_queries=8, dec_layers=2, enc_layers=1, dim_feedforward=64,
            backbone_depth=18, num_points=0)
WEIGHTS = {f"{k}{s}": w for s in ("", "_0", "_1")
           for k, w in (("loss_ce", 2.0), ("loss_mask", 5.0), ("loss_dice", 5.0))}
# tests/test_torch_train_step.py's tolerances and floor
TOL_LOSS, TOL_GRAD, GRAD_FLOOR = 1e-4, 5e-3, 1e-6


def _inputs(n_valid):
    rng = np.random.RandomState(0)
    images = rng.randn(len(n_valid), H, W, 3).astype(np.float32)
    masks = np.zeros((len(n_valid), K, H // 4, W // 4), bool)
    for b, n in enumerate(n_valid):
        for j in range(n):
            masks[b, j, 2 + 3 * j: 8 + 3 * j, 1 + 4 * j: 11 + 3 * j] = True
    labels = rng.randint(0, 5, (len(n_valid), K)).astype(np.int32)
    valid = np.arange(K)[None] < np.asarray(n_valid)[:, None]
    return images, np.asarray([[H, W]] * len(n_valid), np.int32), labels, masks, valid


def _by_name(tree):
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def run():
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        yield _run()
    finally:
        torch.set_num_threads(threads)


def _run():
    jmodel = JaxMaskFormer(**TINY, msda_impl="jnp")
    images, sizes, labels, masks, valid = _inputs((2, 3))
    jt = JaxMaskTargets(jnp.asarray(labels), jnp.asarray(masks), jnp.asarray(valid))
    params = random_params(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.asarray(images), jnp.asarray(sizes), jt, train=False), seed=1)

    def loss_fn(p, x, s, t):
        losses = jmodel.apply({"params": p}, x, s, t, train=True, rngs={"dropout": jax.random.PRNGKey(2)})
        return sum(losses[k] * WEIGHTS[k] for k in losses), losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    port = MaskFormer(**TINY, dtype=torch.float32)
    load_from_jax(port, params)
    port.train()

    def both(n_valid):
        images, sizes, labels, masks, valid = _inputs(n_valid)
        (total, losses), grads = grad_fn(params, jnp.asarray(images), jnp.asarray(sizes),
                                         JaxMaskTargets(jnp.asarray(labels), jnp.asarray(masks), jnp.asarray(valid)))
        want = dict(losses={k: float(v) for k, v in losses.items()}, total=float(total), grads=_by_name(grads))
        port.zero_grad(set_to_none=True)
        got_losses = port(torch.from_numpy(images), torch.from_numpy(sizes),
                          MaskTargets(torch.from_numpy(labels), torch.from_numpy(masks), torch.from_numpy(valid)))
        got_total = sum(got_losses[k] * WEIGHTS[k] for k in got_losses)
        got_total.backward()
        got = dict(losses={k: float(v.detach()) for k, v in got_losses.items()}, total=float(got_total.detach()),
                   grads={n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
                          for n, p in port.named_parameters()})
        return want, got

    return {"valid": both((2, 3)), "empty": both((0, 0))}


def _check_losses(want, got):
    assert set(got["losses"]) == set(want["losses"]) == set(WEIGHTS)
    for k, v in want["losses"].items():
        assert np.isfinite(got["losses"][k]), k
        assert abs(got["losses"][k] - v) <= TOL_LOSS * max(abs(v), 1e-3), (k, got["losses"][k], v)
    assert abs(got["total"] - want["total"]) <= TOL_LOSS * abs(want["total"])


def test_match_cost_matches_jax():
    rng = np.random.RandomState(5)
    b, q, c = 3, 8, 6
    logits = rng.randn(b, q, c).astype(np.float32)
    masks = (rng.randn(b, q, 16, 24) * 3).astype(np.float32)
    labels = rng.randint(0, c - 1, (b, K)).astype(np.int32)
    gt = rng.rand(b, K, 16, 24) > 0.7
    valid = rng.rand(b, K) > 0.3
    want = np.asarray(jax.jit(jax.vmap(jax_match_cost))(*map(jnp.asarray, (logits, masks, labels, gt, valid))))
    got = maskformer_match_cost(*map(torch.from_numpy, (logits, masks, labels, gt, valid))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[~np.repeat(valid[:, None], q, 1)] == 1e9).all()


def test_loss_dict_matches_jax(run):
    _check_losses(*run["valid"])


def test_every_gradient_matches_jax(run):
    want, got = run["valid"]
    assert set(got["grads"]) == set(want["grads"])
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want["grads"].values()))
    errs = {n: np.linalg.norm(g - want["grads"][n]) / (TOL_GRAD * np.linalg.norm(want["grads"][n])
                                                       + GRAD_FLOOR * norm)
            for n, g in got["grads"].items()}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert worst[0][1] <= 1.0, worst
    # the pixel decoder's deformable encoder trains through the MSDA standard entry
    assert np.abs(got["grads"]["pixel_decoder.encoder_0.self_attn.sampling_offsets.weight"]).max() > 0


def test_empty_ground_truth_gives_finite_losses(run):
    want, got = run["empty"]
    _check_losses(want, got)
    assert all(np.isfinite(g).all() for g in got["grads"].values())


def test_weight_dict_equals_jax():
    from vnext_tpu.config import add_maskformer_config as jax_add_maskformer_config
    from vnext_tpu.config import get_cfg as jax_get_cfg

    path = os.path.join(os.path.dirname(__file__), "..", "configs", "minvis", "ovis_r50.yaml")
    jcfg, cfg = jax_get_cfg(), get_cfg()
    jax_add_maskformer_config(jcfg)
    add_maskformer_config(cfg)
    jcfg.merge_from_file(path)
    cfg.merge_from_file(path)
    want = jax_weight_dict(jcfg)
    assert maskformer_weight_dict(cfg) == want
    assert len(want) == 3 * (cfg.MODEL.MASK_FORMER.DEC_LAYERS + 1)
