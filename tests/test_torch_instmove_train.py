"""InstMove training in the port against the JAX package's, on the CPU in f32.

- ``instmove_loss`` (BCE + soft dice, eps 1) on random logits: rtol 1e-6.
- The phase-1 predictor (the memory reads ``long_x`` through
  ``motion_context_encoder``): a random flax tree of JAX's phase-1 init bridges
  key for key, and the forward agrees at tests/test_torch_instmove.py's
  tolerances (rtol 1e-4 / atol 1e-5); a phase-2 tree holds only the matching
  encoder.
- One train step's gradients at the tool's arrangement (the tiny predictor:
  memory 8, 2 ConvLSTM layers of 16 channels, full ResNet-50, 4 past masks of
  32x32 and the 32x32 image crop) against ``jax.grad`` of the JAX tool's loss:
  each parameter's gradient within 5e-3 of its norm plus 1e-6 of the global
  norm (f32 sums in other orders through ResNet-50 and the ConvLSTM).
- One and two updates of ``torch.optim.AdamW`` as the tool builds it against
  ``optax.adamw(BASE_LR, weight_decay=WEIGHT_DECAY)`` on the same gradients,
  over every parameter: element by element within 1e-3 of the learning rate
  plus 2 f32 spacings of the parameter. FrozenBN's statistics and the stem
  move in both.
- ``build_mask_sequences`` and the seeded batches bit-equal to the JAX tool's
  (its module loaded by path) on a synthetic YTVIS dataset of 2 videos x 8
  frames, at 48x64 crops; the JAX tool builds its batches in a closure, so
  the test composes them from its module's pieces exactly as the closure
  does, the init batch first.
- The port's tool for 3 iterations with ``MODEL.DEVICE cpu``: finite losses,
  ``metrics.json``, a periodic checkpoint and ``instmove_final`` that
  ``load_weights`` reads back; ``--resume`` raises.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.flatten_util import ravel_pytree
import pytest
import torch

from vnext_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from vnext_tpu.data.datasets.synthetic import register_synthetic_ytvis as jax_register_synthetic_ytvis
from vnext_tpu.models import instmove as jim
from vnext_tpu_torch.checkpoint.checkpointer import load_weights
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_ytvis
from vnext_tpu_torch.models import instmove as im
from vnext_tpu_torch.tools import train_instmove

from _torch_helpers import random_params, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOTION = os.path.join(REPO, "configs", "minvis", "ovis_r50_motion.yaml")
TINY = dict(memory_size=8, num_lstm_layers=2, lstm_channels=16)
DATASET = "ytvis_synthetic_instmove"
HW = (32, 32)
TOL_GRAD, GRAD_FLOOR = 5e-3, 1e-6


@pytest.fixture
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(old)


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_train_instmove", os.path.join(REPO, "tools", "train_instmove.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """Both packages' DATASET registered on the same files: 2 videos x 8 frames."""
    jax_register_synthetic_ytvis(DATASET, root=str(tmp_path_factory.mktemp("synth") / DATASET), num_frames=8)
    root = os.path.dirname(JaxDatasetCatalog.get(DATASET)[0]["file_names"][0]).rsplit("/JPEGImages", 1)[0]
    register_synthetic_ytvis(DATASET, root=root, num_frames=8)
    return root


def _by_name(tree):
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def test_instmove_loss_matches_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 2, 16, 24, 1) * 4).astype(np.float32)
    gt = rng.rand(3, 2, 16, 24, 1) > 0.6
    want = jim.instmove_loss(jnp.asarray(logits), jnp.asarray(gt))
    got = im.instmove_loss(t(logits), torch.from_numpy(gt))
    assert set(got) == set(want) == {"loss_mask", "loss_dice"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def test_phase_1_forward_matches_jax():
    rng = np.random.RandomState(1)
    short = rng.rand(2, 3, 32, 32, 1).astype(np.float32)
    long = rng.rand(2, 6, 32, 32, 1).astype(np.float32)
    image = rng.randn(2, 32, 32, 3).astype(np.float32)
    jmodel = jim.InstMovePredictor(**TINY)
    args = (jnp.asarray(short), jnp.asarray(image), 1, jnp.asarray(long), 1)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), *args), seed=3)
    assert set(params["memory"]) == {"memory_w", "motion_context_encoder", "embed1", "embed2"}
    port = im.InstMovePredictor(**TINY, phase=1).eval()
    load_from_jax(port, params)
    assert set(params_from_jax(params)) == set(port.state_dict())
    assert not any("motion_matching_encoder" in k for k in port.state_dict())
    assert not any("motion_context_encoder" in k for k in im.InstMovePredictor(**TINY).state_dict())
    want = jax.jit(lambda p: jmodel.apply({"params": p}, *args))(params)
    with torch.no_grad():
        got = port(t(short), t(image), long_x=t(long))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="long_x"):
        port(t(short), t(image))


@pytest.fixture(scope="module")
def step_case():
    """The tiny predictor's flax tree, a batch, JAX's loss and gradients."""
    rng = np.random.RandomState(2)
    past = (rng.rand(2, 4, *HW, 1) > 0.5).astype(np.float32)
    nxt = (rng.rand(2, 1, *HW, 1) > 0.5).astype(np.float32)
    imgs = rng.randn(2, *HW, 3).astype(np.float32)
    jmodel = jim.InstMovePredictor(**TINY)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(past), jnp.asarray(imgs)), seed=4)

    def loss_fn(p):
        losses = jim.instmove_loss(jmodel.apply({"params": p}, jnp.asarray(past), jnp.asarray(imgs), out_len=1),
                                   jnp.asarray(nxt))
        return losses["loss_mask"] + losses["loss_dice"]

    total, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return (past, nxt, imgs), params, float(total), grads


def test_train_step_gradients_match_jax(step_case, threads):
    (past, nxt, imgs), params, want_total, grads = step_case
    port = im.InstMovePredictor(**TINY).train()
    load_from_jax(port, params)
    losses = im.instmove_loss(port(t(past), t(imgs), out_len=1), t(nxt))
    total = losses["loss_mask"] + losses["loss_dice"]
    total.backward()
    assert abs(float(total.detach()) - want_total) <= 1e-4 * want_total
    want = _by_name(grads)
    # the image ResNet's res4 / res5 stages do not run here: no gradient, zeros in JAX
    got = {n: np.zeros_like(want[n]) if p.grad is None else p.grad.numpy() for n, p in port.named_parameters()}
    assert all(not want[n].any() for n, p in port.named_parameters() if p.grad is None)
    assert set(got) == set(want)
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want.values()))
    errs = {n: np.linalg.norm(g - want[n]) / (TOL_GRAD * np.linalg.norm(want[n]) + GRAD_FLOOR * norm)
            for n, g in got.items()}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert worst[0][1] <= 1.0, worst
    for name in ("encoder_img.bn1.running_var", "encoder_img.conv1.weight", "memory.memory_w"):
        assert np.abs(got[name]).max() > 0, name


@pytest.fixture(scope="module")
def adamw_runs(step_case):
    """The same gradients through both optimizers, two updates: the second's
    are the first's scaled by -0.5 plus noise, so the moments mix signs.
    {n_updates: (optax's parameters, the port's)} by port name."""
    _, params, _, grads = step_case
    cfg = _motion_cfg()
    rng = np.random.RandomState(5)
    grad_seq = [grads, jax.tree.map(lambda g: -0.5 * g + 1e-3 * rng.randn(*g.shape).astype(np.float32), grads)]
    tx = optax.adamw(cfg.SOLVER.BASE_LR, weight_decay=cfg.SOLVER.WEIGHT_DECAY)
    # optax.adamw is elementwise (no mask, no clip), so it runs on the tree raveled into one vector
    flat, unravel = ravel_pytree(params)
    opt_state, p = tx.init(flat), flat

    def update(g, opt_state, p):
        updates, opt_state = tx.update(ravel_pytree(g)[0], opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    port = im.InstMovePredictor(**TINY)
    load_from_jax(port, params)
    optimizer = train_instmove.build_instmove_optimizer(cfg, port)
    named = dict(port.named_parameters())
    assert len(optimizer.param_groups) == 1 and len(optimizer.param_groups[0]["params"]) == len(named)
    runs = {}
    for n_updates, g in enumerate(grad_seq, 1):
        p, opt_state = update(g, opt_state, p)
        for n, v in _by_name(g).items():
            named[n].grad = torch.from_numpy(v.copy())
        optimizer.step()
        runs[n_updates] = (_by_name(unravel(p)), {n: v.detach().numpy().copy() for n, v in named.items()})
    return runs, _by_name(params), cfg.SOLVER.BASE_LR


@pytest.mark.parametrize("n_updates", [1, 2])
def test_adamw_over_every_parameter_matches_optax(adamw_runs, n_updates):
    runs, before, lr = adamw_runs
    want, got = runs[n_updates]
    for n, w in want.items():
        bound = 1e-3 * lr + 2 * np.spacing(np.abs(w).astype(np.float32))
        assert (np.abs(got[n] - w) <= bound).all(), (n, float(np.abs(got[n] - w).max()))
    for n in ("encoder_img.bn1.running_mean", "encoder_img.bn1.running_var", "encoder_img.conv1.weight"):
        assert (want[n] != before[n]).any() and (got[n] != before[n]).any(), n


def _motion_cfg(*opts):
    from vnext_tpu_torch.config import add_maskformer_config, get_cfg

    cfg = get_cfg()
    add_maskformer_config(cfg)
    cfg.merge_from_file(MOTION)
    cfg.merge_from_list(list(opts))
    return cfg


def test_mask_sequences_and_batches_equal_jax(synthetic):
    jtool = _jax_tool()
    want = jtool.build_mask_sequences(DATASET, 4, (48, 64))
    got = train_instmove.build_mask_sequences(DATASET, 4, (48, 64))
    assert len(got) == len(want) > 8
    for (gp, gt, gf, gb), (wp, wt, wf, wb) in zip(got, want):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gt, wt)
        assert (gf, gb) == (wf, wb)
    cfg = _motion_cfg()
    mean, std = np.asarray(cfg.MODEL.PIXEL_MEAN), np.asarray(cfg.MODEL.PIXEL_STD)
    jrng, rng = np.random.RandomState(0), np.random.RandomState(0)
    for it in range(3):                     # the JAX tool's closure, the init batch first
        idx = jrng.randint(0, len(want), 4)
        jbatch = (np.stack([want[i][0] for i in idx])[..., None],
                  np.stack([want[i][1] for i in idx])[:, None, ..., None],
                  np.asarray(np.stack([(jtool._load_image(want[i][2], want[i][3], (48, 64)) - mean) / std
                                       for i in idx]), np.float32))
        batch = train_instmove.make_batch(got, rng, 4, (48, 64), mean, std)
        for a, b in zip(batch, jbatch):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert np.abs(batch[2]).max() > 0, "the crops come from the dataset's frames"
    assert not train_instmove._load_image(None, [0, 0, 4, 4], (8, 8)).any()


def test_tool_trains_on_the_cpu_and_refuses_resume(synthetic, tmp_path, threads):
    out = str(tmp_path / "out")
    args = ["--config-file", MOTION, "DATASETS.TRAIN", f"('{DATASET}',)", "MODEL.DEVICE", "cpu", "OUTPUT_DIR", out,
            "SOLVER.MAX_ITER", "3", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.CHECKPOINT_PERIOD", "2",
            "MODEL.INSTMOVE.MASK_SIZE", "[32, 32]", "MODEL.INSTMOVE.MEMORY_SIZE", "8",
            "MODEL.INSTMOVE.LSTM_LAYERS", "2", "MODEL.INSTMOVE.LSTM_CHANNELS", "16"]
    model, storage = train_instmove.main(args)
    hist = storage.history("total_loss")
    assert hist.count() == 3 and np.isfinite(hist.values()).all()
    assert storage.history("loss_dice").count() == 3
    lines = [json.loads(line) for line in open(os.path.join(out, "metrics.json"))]
    assert lines and "loss_mask" in lines[-1]
    assert sorted(f for f in os.listdir(out) if f.endswith(".pth")) == ["instmove_0000002.pth", "instmove_final.pth"]
    loaded = im.build_instmove_model(_motion_cfg("MODEL.INSTMOVE.MEMORY_SIZE", 8, "MODEL.INSTMOVE.LSTM_LAYERS", 2,
                                                 "MODEL.INSTMOVE.LSTM_CHANNELS", 16), device="cpu", seed=7)
    load_weights(os.path.join(out, "instmove_final.pth"), loaded)
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(), model.state_dict().values()))
    with pytest.raises(ValueError, match="--resume"):
        train_instmove.main(["--resume", *args])
