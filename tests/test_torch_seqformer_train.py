"""The port's SeqFormer train forward against the JAX package's, on the CPU in f32.

The tiny SeqFormer of tests/test_model_seqformer.py (hidden 32, 4 heads, 12
queries, 1 encoder and 2 decoder layers, 4 instance slots, 3-frame clips,
full ResNet-50; the JAX package on its jnp MSDA path, dropout 0, since the
frameworks draw different dropout bits) gets one random flax tree of
``SeqFormer.init`` for ``__call__``, bridged to the port. Two clips, with 2
and 3 of 4 slots valid and padded valid sizes, go through both:

The frames are 128x192, not that file's 64x96: there the stride-64 level is
1x2, its GroupNorm normalizes groups of 2 values, and the gradient of the
convolution before it is ill-conditioned in f32 in both packages (against an
f64 evaluation of the port: JAX's 13%, the port's 25% off; each other 10%,
20x the tolerance). At 128x192 the groups hold 6 values.

- ``seqformer_match_cost`` on random predictions within 1e-5;
- the loss dict (``loss_ce``, ``loss_bbox``, ``loss_giou``, ``loss_mask``,
  ``loss_dice`` and their ``_0`` terms) and every parameter's gradient of the
  total weighed by ``seqformer_weight_dict`` (configs/seqformer/ytvis19_r50.yaml's
  weights), at ``tests/test_torch_train_step.py``'s tolerances;
- clips with no valid slot: finite losses, JAX's again.

The JAX side is one ``jit`` of ``value_and_grad``, shared by the cases.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.seqformer import ClipTargets as JaxClipTargets
from vnext_tpu.models.seqformer import SeqFormer as JaxSeqFormer
from vnext_tpu.models.seqformer import seqformer_match_cost as jax_match_cost
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.config import add_seqformer_config, get_cfg
from vnext_tpu_torch.models.seqformer import ClipTargets, SeqFormer, seqformer_match_cost, seqformer_weight_dict

from _torch_helpers import random_params

H, W, NF, K = 128, 192, 3, 4
TINY = dict(num_classes=5, hidden_dim=32, num_queries=12, nheads=4, dim_feedforward=64,
            enc_layers=1, dec_layers=2, max_insts=K, dropout=0.0)
SIZES = np.asarray([[120, 170], [128, 180]], np.int32)
TOL_LOSS, TOL_GRAD, GRAD_FLOOR = 1e-4, 5e-3, 1e-6


def _weights():
    cfg = get_cfg()
    add_seqformer_config(cfg)
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs", "seqformer", "ytvis19_r50.yaml"))
    cfg.MODEL.SeqFormer.DEC_LAYERS = TINY["dec_layers"]
    return seqformer_weight_dict(cfg)


def _inputs(n_valid):
    rng = np.random.RandomState(0)
    b = len(n_valid)
    images = rng.randn(b, NF, H, W, 3).astype(np.float32)
    boxes = np.zeros((b, K, NF, 4), np.float32)
    boxes[..., :2] = rng.rand(b, K, NF, 2) * 0.5 + 0.25
    boxes[..., 2:] = rng.rand(b, K, NF, 2) * 0.2 + 0.1
    masks = np.zeros((b, K, NF, H // 4, W // 4), bool)
    for i, n in enumerate(n_valid):
        for j in range(n):
            masks[i, j, :, 4 + 5 * j: 16 + 5 * j, 3 + 4 * j: 20 + 5 * j] = True
    labels = rng.randint(0, 5, (b, K)).astype(np.int32)
    valid = np.arange(K)[None] < np.asarray(n_valid)[:, None]
    return images, labels, boxes, masks, valid


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
    weights = _weights()
    jmodel = JaxSeqFormer(**{k: v for k, v in TINY.items()}, msda_impl="jnp")
    images, labels, boxes, masks, valid = _inputs((2, 3))
    params = random_params(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.asarray(images),
        jnp.asarray(SIZES), JaxClipTargets(*map(jnp.asarray, (labels, boxes, masks, valid))), train=False), seed=1)

    def loss_fn(p, x, s, t):
        losses = jmodel.apply({"params": p}, x, s, t, train=True, rngs={"dropout": jax.random.PRNGKey(2)})
        return sum(losses[k] * weights[k] for k in losses if k in weights), losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    port = SeqFormer(**TINY, dtype=torch.float32)
    load_from_jax(port, params)
    port.train()

    def both(n_valid):
        images, labels, boxes, masks, valid = _inputs(n_valid)
        (total, losses), grads = grad_fn(params, jnp.asarray(images), jnp.asarray(SIZES),
                                         JaxClipTargets(*map(jnp.asarray, (labels, boxes, masks, valid))))
        want = dict(losses={k: float(v) for k, v in losses.items()}, total=float(total), grads=_by_name(grads))
        port.zero_grad(set_to_none=True)
        got_losses = port(torch.from_numpy(images), torch.from_numpy(SIZES),
                          ClipTargets(*map(torch.from_numpy, (labels, boxes, masks, valid))))
        got_total = sum(got_losses[k] * weights[k] for k in got_losses if k in weights)
        got_total.backward()
        got = dict(losses={k: float(v.detach()) for k, v in got_losses.items()}, total=float(got_total.detach()),
                   grads={n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
                          for n, p in port.named_parameters()})
        return want, got

    return {"valid": both((2, 3)), "empty": both((0, 0))}


def _check_losses(want, got):
    keys = {f"loss_{k}{s}" for k in ("ce", "bbox", "giou", "mask", "dice") for s in ("", "_0")}
    assert set(got["losses"]) == set(want["losses"]) == keys
    for k, v in want["losses"].items():
        assert np.isfinite(got["losses"][k]), k
        assert abs(got["losses"][k] - v) <= TOL_LOSS * max(abs(v), 1e-3), (k, got["losses"][k], v)
    assert abs(got["total"] - want["total"]) <= TOL_LOSS * abs(want["total"])


def test_match_cost_matches_jax():
    rng = np.random.RandomState(5)
    b, q, c = 2, 12, 5
    logits = rng.randn(b, q, c).astype(np.float32)
    boxes = np.concatenate([rng.rand(b, NF, q, 2) * 0.6 + 0.2, rng.rand(b, NF, q, 2) * 0.3 + 0.05], -1)
    gt_boxes = np.concatenate([rng.rand(b, K, NF, 2) * 0.6 + 0.2, rng.rand(b, K, NF, 2) * 0.3 + 0.05], -1)
    gt_boxes[0, 1, 2] = 0.0                                            # a frame where the instance is absent
    labels = rng.randint(0, c, (b, K)).astype(np.int32)
    valid = np.asarray([[True, True, False, True], [True, False, False, False]])
    args = (logits, boxes.astype(np.float32), labels, gt_boxes.astype(np.float32), valid)
    want = np.asarray(jax.jit(jax.vmap(jax_match_cost))(*map(jnp.asarray, args)))
    got = seqformer_match_cost(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


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
    # the time attention, the decoder's MSDA and the dynamic mask head train
    for name in ("transformer.decoder_1.time_attention_weights.weight",
                 "transformer.decoder_0.cross_attn.sampling_offsets.weight", "controller.layers_2.weight"):
        assert np.abs(got["grads"][name]).max() > 0, name


def test_empty_clip_targets_give_finite_losses(run):
    want, got = run["empty"]
    _check_losses(want, got)
    assert all(np.isfinite(g).all() for g in got["grads"].values())
