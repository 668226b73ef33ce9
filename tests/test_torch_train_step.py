"""The port's IDOL train step against the JAX package's, on the CPU in f32.

A tiny IDOL (tests/_tiny_idol.py's widths: hidden 32, 4 heads, 1 encoder and 2
decoder layers, 20 queries, 8 instance slots, full ResNet-50; dropout 0, since
the frameworks draw different dropout bits) gets one random flax parameter tree
of ``IDOL.init`` for ``__call__``, which the weight bridge loads into the port.
Two clips of key + reference frames go through both:

- the loss dict of the port's ``IDOL.forward`` against ``IDOL.apply(...,
  train=True)``;
- the gradient of every parameter;
- the parameters after one step of each ``make_train_step`` under the
  ytvis19_r50 solver (AdamW, lr 1e-4, wd 1e-4, backbone x0.1, full-model clip
  at 0.01, which is active: the norm is far above it);
- frozen parameters stay bit-equal, and the clip's norm counts their gradients,
  as JAX's does.

The JAX side is one ``jit`` of its train step; a first link in its optimizer
chain keeps the raw gradients in the optimizer state, so the same program
returns them.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vnext_tpu.engine.train_step import TrainState as JaxTrainState
from vnext_tpu.engine.train_step import make_train_step as jax_make_train_step
from vnext_tpu.engine.trainer import batch_to_model_inputs as jax_inputs
from vnext_tpu.models.criterion import default_weight_dict as jax_weight_dict
from vnext_tpu.models.idol import IDOL as JaxIDOL
from vnext_tpu.solver import build_optimizer as jax_build_optimizer
from vnext_tpu.solver.build import backbone_mask as jax_backbone_mask
from vnext_tpu.solver.build import build_lr_schedule as jax_lr_schedule
from vnext_tpu.solver.build import frozen_mask as jax_frozen_mask
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.engine.train_step import TrainState, make_train_step
from vnext_tpu_torch.engine.trainer import PIXEL_MEAN, PIXEL_STD, batch_to_model_inputs
from vnext_tpu_torch.models import idol as port_idol
from vnext_tpu_torch.models.criterion import default_weight_dict
from vnext_tpu_torch.models.idol import IDOL
from vnext_tpu_torch.solver import build as solver

from _tiny_idol import NQ
from _torch_helpers import TINY_IDOL, random_params, rel_l2, tiny_batch, ytvis19_r50_cfg

torch.set_num_threads(4)

TINY = dict(max_insts=8, dropout=0.0)
# f32 on both sides through ResNet-50 and the trunk, sums in other orders; the
# losses are means over many terms, so their relative error stays near f32's
# rounding times the depth
TOL_LOSS = 1e-4
# a gradient adds one more pass through the same depth. The tiny model's
# stride-64 level is 1x2 and its GroupNorm has one channel per group, so it
# normalizes 2 values and amplifies the rounding of the conv before it: that
# conv's gradient is the worst, ~3.5e-3
TOL_GRAD = 5e-3
# a gradient that is zero in exact arithmetic (a bias before a GroupNorm with
# one channel per group, the key projection's bias) is rounding noise on both
# sides, so each gradient's error also has an absolute floor
GRAD_FLOOR = 1e-6          # of the global gradient norm
# the first AdamW step moves a parameter by u = -lr * (g / (|g| + eps) + wd * p)
# with g the clipped gradient; du/dg <= 1/eps, so a gradient error dg moves u by
# at most lr * dg / eps. Checked per element, beside 1e-3 * lr for the other
# roundings and two f32 spacings of p for the stores
TOL_UPDATE = 1e-3


def _tree_by_name(tree):
    """flax tree -> {port parameter name: numpy array} (the bridge's naming)."""
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def run():
    cfg = ytvis19_r50_cfg()
    batch = tiny_batch(0)
    jmodel = JaxIDOL(num_classes=5, hidden_dim=32, num_queries=NQ, nheads=4, dim_feedforward=64,
                     enc_layers=1, dec_layers=2, msda_impl="jnp", **TINY)
    jin = jax_inputs(batch, PIXEL_MEAN, PIXEL_STD)
    params = random_params(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, *jin, train=False), seed=1)
    weights = jax_weight_dict(dec_layers=2)
    # a first link that keeps the raw gradients in its state, so that the one
    # compiled train step also returns them
    stash = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                         lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(stash, jax_build_optimizer(cfg, params))
    step = jax_make_train_step(jmodel, tx, weights, donate=False)
    new_state, metrics = step(JaxTrainState.create(params, tx), jin, jax.random.PRNGKey(0))
    grads = new_state.opt_state[0]
    want = dict(losses={k: float(v) for k, v in metrics.items() if k != "total_loss"},
                total=float(metrics["total_loss"]), grads=_tree_by_name(grads),
                grad_norm=float(optax.global_norm(grads)), before=_tree_by_name(params),
                after=_tree_by_name(new_state.params))

    port = IDOL(**TINY_IDOL, **TINY, dtype=torch.float32)
    load_from_jax(port, params)                      # the __call__ tree bridges whole
    optimizer = solver.build_optimizer(cfg, port)
    state = TrainState.create(port, optimizer, solver.build_lr_scheduler(cfg, optimizer))
    train_step = make_train_step(port, optimizer, default_weight_dict(dec_layers=2),
                                 clip=solver.build_grad_clip(cfg))
    inputs = batch_to_model_inputs(batch, PIXEL_MEAN, PIXEL_STD, "cpu")
    state, metrics = train_step(state, inputs)
    # the step leaves the clipped gradients: undo the clip's scale
    unclip = float(metrics["grad_norm"]) / cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE
    got = dict(metrics={k: float(v) for k, v in metrics.items()},
               grads={n: p.grad.numpy() * unclip for n, p in port.named_parameters()},
               after={n: p.detach().numpy().copy() for n, p in port.named_parameters()})
    return want, got, state


def test_loss_dict_matches_jax(run):
    want, got, _ = run
    assert set(got["metrics"]) == set(want["losses"]) | {"total_loss", "grad_norm"}
    for k, v in want["losses"].items():
        assert abs(got["metrics"][k] - v) <= TOL_LOSS * max(abs(v), 1e-3), (k, got["metrics"][k], v)
    assert abs(got["metrics"]["total_loss"] - want["total"]) <= TOL_LOSS * want["total"]


def test_every_gradient_matches_jax(run):
    want, got, _ = run
    assert set(got["grads"]) == set(want["grads"])
    floor = GRAD_FLOOR * want["grad_norm"]
    errs = {n: np.linalg.norm(g - want["grads"][n]) / (TOL_GRAD * np.linalg.norm(want["grads"][n]) + floor)
            for n, g in got["grads"].items()}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert worst[0][1] <= 1.0, worst


def test_parameters_after_one_step_match_jax(run):
    want, got, state = run
    assert state.step == 1
    cfg = ytvis19_r50_cfg()
    eps = 1e-8                                                    # AdamW's, both sides
    clip = cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE
    for n, after in got["after"].items():
        if solver.is_frozen(n):
            continue
        before = want["before"][n]
        upd_got, upd_want = after - before, want["after"][n] - before
        assert np.abs(upd_want).max() > 0, n
        lr = cfg.SOLVER.BASE_LR * (cfg.SOLVER.BACKBONE_MULTIPLIER if solver.is_backbone(n) else 1.0)
        dg = np.abs(got["grads"][n] * clip / got["metrics"]["grad_norm"]
                    - want["grads"][n] * clip / want["grad_norm"])
        bound = lr * (dg / eps + TOL_UPDATE) + 2 * np.spacing(np.abs(before))
        excess = np.abs(upd_got - upd_want) / bound
        assert excess.max() <= 1.0, (n, float(excess.max()))


def test_frozen_parameters_stay_and_the_clip_counts_them(run):
    want, got, _ = run
    frozen = [n for n in got["after"] if solver.is_frozen(n)]
    assert len(frozen) > 100
    for n in frozen:
        np.testing.assert_array_equal(got["after"][n], want["before"][n])
    # the clip's norm is JAX's global norm over every gradient, frozen ones
    # included; without them it would be smaller by more than the tolerance
    norm = got["metrics"]["grad_norm"]
    assert norm == pytest.approx(want["grad_norm"], rel=1e-3)
    trainable = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                            for n, g in got["grads"].items() if not solver.is_frozen(n)))
    assert norm > trainable * 1.01
    assert norm > 100 * 0.01                                      # the clip at 0.01 is active


def test_solver_groups_equal_jax_masks():
    jmodel = JaxIDOL(num_classes=5, hidden_dim=32, num_queries=NQ, nheads=4, dim_feedforward=64,
                     enc_layers=1, dec_layers=2)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 96, 3)), jnp.asarray([[64, 96]]),
        method=JaxIDOL.inference))["params"]

    def by_name(mask):
        """a bool per leaf -> {port name: bool}, through the bridge's naming"""
        full = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), mask, shapes)
        return {n: bool(v.flat[0]) for n, v in _tree_by_name(full).items()}

    port = IDOL(**TINY_IDOL, **TINY)
    frozen = solver.frozen_mask(port)
    assert frozen == by_name(jax_frozen_mask(shapes))
    assert solver.backbone_mask(port) == by_name(jax_backbone_mask(shapes))
    assert 100 < sum(frozen.values()) < len(frozen)


@pytest.mark.parametrize("warmup_factor", [1.0, 0.001])
def test_lr_schedule_matches_jax(warmup_factor):
    cfg = ytvis19_r50_cfg()
    cfg.SOLVER.WARMUP_FACTOR = warmup_factor
    schedule = jax_lr_schedule(cfg)
    optimizer = torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))], lr=cfg.SOLVER.BASE_LR)
    scheduler = solver.build_lr_scheduler(cfg, optimizer)
    port_schedule = solver.build_lr_schedule(cfg)
    seen = {}
    for step in range(8002):
        seen[step] = optimizer.param_groups[0]["lr"]
        optimizer.step()
        scheduler.step()
    for step in (0, 1, 5, 9, 10, 7999, 8000, 8001):
        want = float(schedule(step))
        assert seen[step] == pytest.approx(want, rel=1e-6), step
        assert port_schedule(step) == pytest.approx(want, rel=1e-6), step


def test_build_idol_model_defaults_to_the_card(monkeypatch):
    assert inspect.signature(port_idol.build_idol_model).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_idol.build_idol_model()
