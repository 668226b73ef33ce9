"""Swin training in the port against the JAX package's, on the CPU.

- Drop-path's formula: on the same branch tensor and the same keep mask, the
  port's ``SwinBlock._drop_path`` equals JAX's ``_drop_path`` exactly, in f32
  and in bf16 (``x * mask / keep``, keep rounded to x's dtype as JAX rounds a
  weakly typed Python float).
- The rate table and the draw order: a tiny Swin (embed 32, depths 2/2/2/2,
  window 7) in train mode at drop-path 0.3 on both sides, with
  ``jax.random.bernoulli`` patched to return pre-drawn masks in call order and
  the port's ``drop_path_mask`` fed the same masks: the sequence of (keep,
  shape) is equal (14 draws; the first block's rate is 0 and it draws
  nothing), and res2..res5 agree element by element (rtol 1e-4 / atol 1e-5, f32
  sums in other orders). Train mode at rate 0 equals eval mode exactly.
- IDOL and SeqFormer on a tiny Swin (embed 32, depths 1/1/2/1, window 4, the
  one of tests/test_torch_swin_models.py) at drop-path 0 and dropout 0: the train
  forward's losses (rtol 1e-4) and every parameter's gradient of the weighted
  total (5e-3 of its norm plus 1e-6 of the global norm), as
  tests/test_torch_train_step.py and tests/test_torch_seqformer_train.py hold
  the R50 models. The frames are 128x192 for the reason SeqFormer's file
  gives: at 64x96 the stride-64 level is 1x2, its GroupNorm normalizes
  2-value groups, and the convolution before it gets an ill-conditioned
  gradient (IDOL-Swin's ``input_proj_3`` read 2.7x its tolerance there).
- Resume: a tiny-Swin IDOL at drop-path 0.3 trained 2 steps, saved, resumed
  into other weights and given a third batch equals 3 straight steps bit for
  bit (the draws are a function of seed and step); through ``train_net`` on a
  tiny-Swin version of the quick-schedule config, ``--resume`` restores the
  saved state bit for bit and trains on.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.engine.trainer import batch_to_model_inputs as jax_inputs
from vnext_tpu.models.backbones import swin as jax_swin
from vnext_tpu.models.criterion import default_weight_dict as jax_weight_dict
from vnext_tpu.models.idol import IDOL as JaxIDOL
from vnext_tpu.models.seqformer import ClipTargets as JaxClipTargets
from vnext_tpu.models.seqformer import SeqFormer as JaxSeqFormer
from vnext_tpu_torch.checkpoint.checkpointer import Checkpointer
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.engine.train_step import TrainState, make_train_step
from vnext_tpu_torch.engine.trainer import PIXEL_MEAN, PIXEL_STD, VISTrainer, batch_to_model_inputs
from vnext_tpu_torch.models.backbones import swin
from vnext_tpu_torch.models.criterion import default_weight_dict
from vnext_tpu_torch.models.idol import IDOL
from vnext_tpu_torch.models.layers import init_weights
from vnext_tpu_torch.models.seqformer import ClipTargets, SeqFormer
from vnext_tpu_torch.solver import build as solver

from _torch_helpers import TINY_IDOL, random_params, tiny_batch, ytvis19_r50_cfg

TINY_SWIN = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window_size=7)
# the models' preset tuple for the train-forward parity: tests/test_torch_swin_models.py's tiny Swin
# (the padded and shifted windows of every stage) at drop-path 0, which jits in half the time of TINY_SWIN
SWIN0 = (32, (1, 1, 2, 1), (2, 2, 4, 4), 4, 0.0)
RATE = 0.3
TOL_LOSS, TOL_GRAD, GRAD_FLOOR = 1e-4, 5e-3, 1e-6


@pytest.fixture
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(old)


def _masks(n_draws, n, seed):
    """Pre-drawn keep masks [n, 1, 1, 1] (bool), about RATE of them dropped."""
    rng = np.random.RandomState(seed)
    return [rng.rand(n, 1, 1, 1) >= RATE for _ in range(n_draws)]


@pytest.fixture
def jax_draws(monkeypatch):
    """``jax.random.bernoulli`` returning the masks of ``draws["masks"]`` in call
    order, recording each call's (p, shape)."""
    draws = {"masks": [], "calls": []}

    def bernoulli(key, p, shape):
        draws["calls"].append((float(p), tuple(shape)))
        return jnp.asarray(draws["masks"][len(draws["calls"]) - 1])

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return draws


@pytest.fixture
def port_draws(monkeypatch):
    draws = {"masks": [], "calls": []}

    def mask(n, keep, generator, device):
        draws["calls"].append((keep, (n, 1, 1, 1)))
        return torch.from_numpy(draws["masks"][len(draws["calls"]) - 1])

    monkeypatch.setattr(swin, "drop_path_mask", mask)
    return draws


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drop_path_formula_equals_jax(dtype, jax_draws, port_draws):
    x = np.random.RandomState(0).randn(6, 5, 7, 8).astype(np.float32)
    jax_draws["masks"] = port_draws["masks"] = _masks(1, 6, seed=1)
    jx = jnp.asarray(x).astype(dtype)
    block = jax_swin.SwinBlock(dim=8, num_heads=2, drop_path=RATE, dtype=getattr(jnp, dtype))
    want = block.apply({}, jx, True, method=lambda m, x, train: m._drop_path(x, train),
                       rngs={"dropout": jax.random.PRNGKey(0)})
    port = swin.SwinBlock(8, 2, drop_path=RATE, dtype=getattr(torch, dtype)).train()
    got = port._drop_path(torch.from_numpy(x).to(getattr(torch, dtype)), None)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert jax_draws["calls"] == [(1.0 - RATE, (6, 1, 1, 1))] == port_draws["calls"]


def test_rate_table_and_draw_order_equal_jax(jax_draws, port_draws):
    images = np.random.RandomState(0).randn(3, 56, 84, 3).astype(np.float32)
    jmodel = jax_swin.SwinTransformer(**TINY_SWIN, drop_path_rate=RATE)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images)), seed=1)
    port = swin.SwinTransformer(**TINY_SWIN, drop_path_rate=RATE)
    load_from_jax(port, params)
    n_draws = 2 * (sum(TINY_SWIN["depths"]) - 1)
    jax_draws["masks"] = port_draws["masks"] = _masks(n_draws, 3, seed=2)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, True, rngs={"dropout": jax.random.PRNGKey(0)}))(
        params, jnp.asarray(images))
    with torch.no_grad():
        got = port.train()(torch.from_numpy(images))
    rates = np.linspace(0, RATE, sum(TINY_SWIN["depths"])).tolist()
    assert [b.drop_path for n, b in port.named_modules() if isinstance(b, swin.SwinBlock)] == rates
    expect = [(1.0 - r, (3, 1, 1, 1)) for r in rates[1:] for _ in range(2)]
    assert len(jax_draws["calls"]) == len(port_draws["calls"]) == n_draws
    assert port_draws["calls"] == expect
    np.testing.assert_allclose([p for p, _ in jax_draws["calls"]], [k for k, _ in expect], rtol=0, atol=0)
    assert [s for _, s in jax_draws["calls"]] == [s for _, s in expect]
    for k in ("res2", "res3", "res4", "res5"):
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_train_mode_at_rate_0_equals_eval():
    net = swin.SwinTransformer(**TINY_SWIN, drop_path_rate=0.0)
    init_weights(net, 0)
    x = torch.randn(2, 40, 52, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        train = net.train()(x, torch.Generator().manual_seed(1))
        evals = net.eval()(x)
    assert all(torch.equal(train[k], evals[k]) for k in evals)


# ---------------------------------------------------------------- train forward
def _by_name(tree):
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _check(want, got):
    assert set(got["losses"]) == set(want["losses"])
    for k, v in want["losses"].items():
        assert np.isfinite(got["losses"][k]), k
        assert abs(got["losses"][k] - v) <= TOL_LOSS * max(abs(v), 1e-3), (k, got["losses"][k], v)
    assert set(got["grads"]) == set(want["grads"])
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want["grads"].values()))
    errs = {n: np.linalg.norm(g - want["grads"][n]) / (TOL_GRAD * np.linalg.norm(want["grads"][n])
                                                       + GRAD_FLOOR * norm)
            for n, g in got["grads"].items()}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert worst[0][1] <= 1.0, worst
    for name in ("backbone.layers_2_blocks_1.attn.qkv.weight", "backbone.layers_3_blocks_0.mlp_fc2.weight",
                 "backbone.patch_embed.weight"):
        assert np.abs(got["grads"][name]).max() > 0, name


def _port_grads(port, losses, weights):
    total = sum(losses[k] * weights[k] for k in losses if k in weights)
    total.backward()
    return dict(losses={k: float(v.detach()) for k, v in losses.items()},
                grads={n: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy().copy()
                       for n, p in port.named_parameters()})


def _batch_128x192(seed):
    """One clip of tests/_torch_helpers.py's tiny batch with every pixel and
    mask cell doubled along both sides (the boxes are normalized)."""
    batch = tiny_batch(seed, n_valid=(3,))
    for prefix in ("key", "ref"):
        for k in ("image", "masks_s4"):
            a = batch[f"{prefix}_{k}"]
            batch[f"{prefix}_{k}"] = a.repeat(2, axis=-3 if k == "image" else -2).repeat(
                2, axis=-2 if k == "image" else -1)
        batch[f"{prefix}_size"] = batch[f"{prefix}_size"] * 2
    return batch


def test_idol_swin_train_forward_matches_jax(threads):
    batch = _batch_128x192(0)
    jmodel = JaxIDOL(**TINY_IDOL, max_insts=8, dropout=0.0, msda_impl="jnp", backbone_type="swin", swin=SWIN0)
    jin = jax_inputs(batch, PIXEL_MEAN, PIXEL_STD)
    params = random_params(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, *jin, train=False), seed=1)
    weights = jax_weight_dict(dec_layers=2)

    def loss_fn(p):
        losses = jmodel.apply({"params": p}, *jin, train=True, rngs={"dropout": jax.random.PRNGKey(2)})
        return sum(losses[k] * weights[k] for k in losses if k in weights), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = dict(losses={k: float(v) for k, v in losses.items()}, grads=_by_name(grads))
    port = IDOL(**TINY_IDOL, max_insts=8, dropout=0.0, backbone_type="swin", swin=SWIN0, dtype=torch.float32)
    load_from_jax(port, params)
    port.train()
    inputs = batch_to_model_inputs(batch, PIXEL_MEAN, PIXEL_STD, "cpu")
    got = _port_grads(port, port(*inputs, generator=torch.Generator().manual_seed(0)),
                      default_weight_dict(dec_layers=2))
    _check(want, got)


def test_seqformer_swin_train_forward_matches_jax(threads):
    from test_torch_seqformer_train import SIZES, TINY, _inputs, _weights

    weights = _weights()
    images, labels, boxes, masks, valid = _inputs((3,))
    sizes = SIZES[:1]
    jt = JaxClipTargets(*map(jnp.asarray, (labels, boxes, masks, valid)))
    jmodel = JaxSeqFormer(**TINY, msda_impl="jnp", backbone_type="swin", swin=SWIN0)
    params = random_params(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, jnp.asarray(images),
        jnp.asarray(sizes), jt, train=False), seed=1)

    def loss_fn(p):
        losses = jmodel.apply({"params": p}, jnp.asarray(images), jnp.asarray(sizes), jt, train=True,
                              rngs={"dropout": jax.random.PRNGKey(2)})
        return sum(losses[k] * weights[k] for k in losses if k in weights), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    want = dict(losses={k: float(v) for k, v in losses.items()}, grads=_by_name(grads))
    port = SeqFormer(**TINY, backbone_type="swin", swin=SWIN0, dtype=torch.float32)
    load_from_jax(port, params)
    port.train()
    got = _port_grads(port, port(torch.from_numpy(images), torch.from_numpy(sizes),
                                 ClipTargets(*map(torch.from_numpy, (labels, boxes, masks, valid))),
                                 generator=torch.Generator().manual_seed(0)), weights)
    _check(want, got)


# ---------------------------------------------------------------- resume
def _state(seed=0):
    cfg = ytvis19_r50_cfg()
    model = IDOL(**TINY_IDOL, max_insts=8, dropout=0.1, backbone_type="swin",
                 swin=(TINY_SWIN["embed_dim"], TINY_SWIN["depths"], TINY_SWIN["num_heads"], TINY_SWIN["window_size"], RATE))
    init_weights(model, seed)
    optimizer = solver.build_optimizer(cfg, model)
    state = TrainState.create(model, optimizer, solver.build_lr_scheduler(cfg, optimizer))
    step = make_train_step(model, optimizer, default_weight_dict(dec_layers=2), solver.build_grad_clip(cfg), seed=3)
    return state, step


def _state_dicts_equal(a, b):
    assert a.step == b.step
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])


def test_resumed_swin_run_equals_the_straight_run_bit_for_bit(tmp_path, monkeypatch):
    seen = []
    draw = swin.drop_path_mask
    monkeypatch.setattr(swin, "drop_path_mask", lambda *a: seen.append(draw(*a)) or seen[-1])
    inputs = [batch_to_model_inputs(tiny_batch(i), PIXEL_MEAN, PIXEL_STD, "cpu") for i in range(3)]
    straight, step = _state()
    for x in inputs:
        straight, _ = step(straight, x)
    kept = torch.cat([m.flatten() for m in seen]).float()
    assert 0 < kept.mean() < 1, "drop-path must drop some samples and keep others at rate 0.3"

    first, step1 = _state()
    for x in inputs[:2]:
        first, _ = step1(first, x)
    Checkpointer(str(tmp_path)).save("model_0000001", VISTrainer(step1, first, iter([]), "cpu").checkpoint_state())
    resumed, step2 = _state(seed=9)
    resumed, start_iter = Checkpointer(str(tmp_path)).resume_or_load("", resumed, resume=True)
    assert start_iter == 2
    _state_dicts_equal(resumed, first)
    resumed, metrics = step2(resumed, inputs[2])
    assert np.isfinite(float(metrics["total_loss"]))
    _state_dicts_equal(resumed, straight)


def test_train_net_trains_and_resumes_a_swin_idol(tmp_path, monkeypatch):
    from test_torch_train_net import INSTANT

    from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_ytvis
    from vnext_tpu_torch.tools import train_net

    register_synthetic_ytvis(root=str(tmp_path / "ytvis_synthetic_tiny"))
    out = str(tmp_path / "out")
    base = ["--config-file", INSTANT, "MODEL.DEVICE", "cpu", "OUTPUT_DIR", out, "TEST.FINAL_LOSS_BOUND", "1e4",
            "SOLVER.CHECKPOINT_PERIOD", "2", "MODEL.BACKBONE.NAME", "D2SwinTransformer",
            "MODEL.SWIN.EMBED_DIM", "32", "MODEL.SWIN.DEPTHS", "[2, 2, 2, 2]", "MODEL.SWIN.NUM_HEADS", "[2, 2, 4, 4]",
            "MODEL.SWIN.WINDOW_SIZE", "7", "MODEL.SWIN.DROP_PATH_RATE", str(RATE)]
    trainer = train_net.main([*base, "SOLVER.MAX_ITER", "2"])
    assert trainer.iter == 2 and trainer.state.step == 2
    assert trainer.state.model.backbone.layers_3_blocks_1.drop_path == pytest.approx(RATE)
    saved = torch.load(os.path.join(out, "model_0000001.pth"), map_location="cpu", weights_only=False)

    restored = {}
    resume_or_load = Checkpointer.resume_or_load

    def spy(self, path, state, resume):
        state, start = resume_or_load(self, path, state, resume)
        restored.update({k: v.clone() for k, v in state.model.state_dict().items()}, start=start)
        return state, start

    monkeypatch.setattr(Checkpointer, "resume_or_load", spy)
    resumed = train_net.main(["--resume", *base, "SOLVER.MAX_ITER", "3"])
    assert restored.pop("start") == 2 and resumed.iter == 3 and resumed.state.step == 3
    assert restored.keys() == saved["model"].keys()
    assert all(torch.equal(restored[k], saved["model"][k]) for k in restored)
