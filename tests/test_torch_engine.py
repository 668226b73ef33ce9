"""The port's training loop: event storage, writers, hooks and ``VISTrainer``.

Checked on the CPU against the JAX package's storage where the two share a
surface (the smoothing of ``HistoryBuffer``), and on their own for what the
loop promises: each step's metrics reach the storage one step late, a
non-finite total loss raises, the writers and the checkpointer run on their
periods, and a real run of the tiny IDOL (dropout 0.1, ytvis19_r50 solver)
moves every trainable parameter and no frozen one.
"""

import json

import numpy as np
import pytest
import torch

from vnext_tpu.utils.events import HistoryBuffer as JaxHistoryBuffer
from vnext_tpu_torch.checkpoint.checkpointer import Checkpointer
from vnext_tpu_torch.engine.hooks import (HookBase, IterationTimer, LRTracker, PeriodicCheckpointer,
                                          PeriodicWriter)
from vnext_tpu_torch.engine.train_step import TrainState, dropout_generator, make_train_step
from vnext_tpu_torch.engine.trainer import VISTrainer, batch_to_model_inputs
from vnext_tpu_torch.models.criterion import default_weight_dict
from vnext_tpu_torch.models.idol import IDOL
from vnext_tpu_torch.models.layers import init_weights
from vnext_tpu_torch.solver import build as solver
from vnext_tpu_torch.utils.events import (CommonMetricPrinter, EventStorage, HistoryBuffer, JSONWriter,
                                          get_event_storage)

from _torch_helpers import TINY_IDOL, tiny_batch, ytvis19_r50_cfg

torch.set_num_threads(4)


def test_history_buffer_smooths_as_jax():
    values = np.random.RandomState(0).randn(37)
    port, jax_buf = HistoryBuffer(20), JaxHistoryBuffer(20)
    for v in values:
        port.update(v)
        jax_buf.update(v)
    for w in (None, 5, 20):
        assert port.median(w) == jax_buf.median(w)
    assert port.global_avg() == pytest.approx(jax_buf.global_avg(), rel=1e-12)
    assert port.values() == list(values[-20:]) and port.count() == 37


def test_storage_scope():
    with pytest.raises(RuntimeError):
        get_event_storage()
    with EventStorage(3) as s:
        assert get_event_storage() is s
        s.put_scalar("x", 1.0)
        assert s.latest() == {"x": (1.0, 3)}
        with pytest.raises(ValueError, match="smoothing_hint"):
            s.put_scalar("x", 2.0, smoothing_hint=False)
    with pytest.raises(RuntimeError):
        get_event_storage()


def _fake_step(losses):
    """A train step that returns the given total losses in turn."""
    def step(state, inputs):
        state.step += 1
        return state, {"total_loss": torch.tensor(losses[state.step - 1]), "loss_x": torch.tensor(1.0)}
    return step


class _Recorder(HookBase):
    def __init__(self):
        self.calls = []

    def before_train(self):
        self.calls.append("before_train")

    def before_step(self):
        self.calls.append(f"before_{self.trainer.iter}")

    def after_step(self):
        seen = self.trainer.storage.history("total_loss").values() if "total_loss" in \
            self.trainer.storage.histories() else []
        self.calls.append(f"after_{self.trainer.iter}:{seen}")

    def after_train(self):
        self.calls.append("after_train")


def _batches(n):
    return iter([tiny_batch(i, n_valid=(2,)) for i in range(n)])


def test_metrics_one_step_late_writers_and_checkpoints(tmp_path):
    state = TrainState.create(torch.nn.Linear(2, 2), torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1))
    trainer = VISTrainer(_fake_step([5.0, 4.0, 3.0]), state, _batches(3), "cpu")
    rec = _Recorder()
    trainer.register_hooks([rec, IterationTimer(warmup_iter=0), LRTracker(lambda step: 0.1 * (step + 1)),
                            PeriodicWriter([JSONWriter(str(tmp_path / "metrics.json")), CommonMetricPrinter(3)],
                                           period=1),
                            PeriodicCheckpointer(Checkpointer(str(tmp_path)), period=2)])
    trainer.train(0, 3)
    # step i's metrics are in the storage after step i + 1 (the last after the loop)
    assert rec.calls == ["before_train", "before_0", "after_0:[]", "before_1", "after_1:[5.0]",
                         "before_2", "after_2:[5.0, 4.0]", "after_train"]
    assert trainer.storage.history("total_loss").values() == [5.0, 4.0, 3.0]
    lines = [json.loads(line) for line in (tmp_path / "metrics.json").read_text().splitlines()]
    assert [w["iteration"] for w in lines] == [0, 1, 2, 3]
    # smoothed: the upper median of the window, as the JAX package's storage smooths
    assert [w.get("total_loss") for w in lines][1:] == [5.0, 5.0, 4.0]
    assert [w["lr"] for w in lines[:3]] == pytest.approx([0.1, 0.2, 0.3])
    assert sorted(p.name for p in tmp_path.glob("*.pth")) == ["model_0000001.pth", "model_0000002.pth"]
    saved = torch.load(tmp_path / "model_0000002.pth", weights_only=False)
    assert saved["step"] == 3 and set(saved) == {"step", "model", "optimizer", "scheduler"}
    assert (tmp_path / "last_checkpoint").read_text() == "model_0000002.pth"


def test_batch_adapter_makes_the_step_inputs():
    """``VISTrainer(batch_adapter=)`` hands the step what the adapter makes of
    each batch (MinVIS's entry point passes one), in place of IDOL's inputs."""
    seen = []

    def step(state, inputs):
        seen.append(inputs)
        return state, {"total_loss": torch.tensor(1.0)}

    state = TrainState.create(torch.nn.Linear(2, 2), torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1))
    trainer = VISTrainer(step, state, _batches(2), "cpu", batch_adapter=lambda b: ("adapted", b["key_size"]))
    trainer.train(0, 2)
    assert [s[0] for s in seen] == ["adapted", "adapted"]
    np.testing.assert_array_equal(seen[1][1], tiny_batch(1, n_valid=(2,))["key_size"])


def test_non_finite_loss_raises():
    state = TrainState.create(torch.nn.Linear(2, 2), torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1))
    trainer = VISTrainer(_fake_step([1.0, float("nan"), 1.0, 1.0]), state, _batches(4), "cpu")
    with pytest.raises(FloatingPointError, match="iteration=2"):
        trainer.train(0, 4)


def test_tiny_idol_trains_through_the_loop(tmp_path):
    """Two real steps on the CPU: finite losses, every trainable parameter
    moves, every frozen one (FrozenBN, stem, layer1) stays bit-equal."""
    cfg = ytvis19_r50_cfg()
    model = IDOL(**TINY_IDOL, max_insts=8, dropout=0.1)
    init_weights(model, 0)
    optimizer = solver.build_optimizer(cfg, model)
    state = TrainState.create(model, optimizer, solver.build_lr_scheduler(cfg, optimizer))
    step = make_train_step(model, optimizer, default_weight_dict(dec_layers=2), solver.build_grad_clip(cfg))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = VISTrainer(step, state, iter([tiny_batch(0), tiny_batch(1)]), "cpu")
    trainer.train(0, 2)
    hist = trainer.storage.histories()
    assert hist["total_loss"].count() == 2 and np.isfinite(hist["total_loss"].values()).all()
    assert len([k for k in hist if k.startswith("loss_")]) == 5 * 2 + 2
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        assert same == solver.is_frozen(n), n
    assert state.step == 2 and optimizer.param_groups[0]["name"] == "backbone"


def test_dropout_draws_follow_seed_and_step():
    a = torch.rand(4, generator=dropout_generator(0, 3, "cpu"))
    assert torch.equal(a, torch.rand(4, generator=dropout_generator(0, 3, "cpu")))
    assert not torch.equal(a, torch.rand(4, generator=dropout_generator(0, 4, "cpu")))
    assert not torch.equal(a, torch.rand(4, generator=dropout_generator(1, 3, "cpu")))


def test_batch_to_model_inputs_normalizes_and_keeps_targets():
    batch = tiny_batch(0)
    key, key_size, ref, ref_size, det, rt = batch_to_model_inputs(batch, (10.0, 20.0, 30.0), (2.0, 2.0, 2.0), "cpu")
    np.testing.assert_allclose(key.numpy(), (batch["key_image"] - np.asarray([10.0, 20.0, 30.0])) / 2.0,
                               rtol=1e-6)
    assert key.dtype == torch.float32 and key_size.tolist() == batch["key_size"].tolist()
    assert torch.equal(det.masks_s4, torch.from_numpy(batch["key_masks_s4"]))
    assert rt.valid.sum() < det.valid.sum()
