"""The port's checkpointer: save, the ``last_checkpoint`` marker, resume, and
weights-only loads, on the CPU.

``resume_or_load`` restores the model, optimizer, scheduler and step, so a tiny
IDOL (dropout 0.1, the ytvis19_r50 solver) trained 2 steps, saved, resumed
into a fresh model and given the third batch equals 3 straight steps on the
same 3 batches bit for bit: the dropout draws are a function of (seed, step).
The test feeds the batches itself, because the loader starts again from its
seed after a resume, as the JAX package's does. A reference-format ``.pth``
(the published checkpoints' names) goes through ``torch_import``; a missing
``MODEL.WEIGHTS`` file raises, as in the JAX package.
"""

import numpy as np
import pytest
import torch

from vnext_tpu_torch.checkpoint import torch_import
from vnext_tpu_torch.checkpoint.checkpointer import LAST_CHECKPOINT_FILE, Checkpointer, load_weights
from vnext_tpu_torch.engine.hooks import BestCheckpointer, EvalHook, HookBase, PeriodicCheckpointer
from vnext_tpu_torch.engine.train_step import TrainState, make_train_step
from vnext_tpu_torch.engine.trainer import PIXEL_MEAN, PIXEL_STD, VISTrainer, batch_to_model_inputs
from vnext_tpu_torch.models.criterion import default_weight_dict
from vnext_tpu_torch.models.idol import IDOL
from vnext_tpu_torch.models.layers import init_weights
from vnext_tpu_torch.solver import build as solver
from vnext_tpu_torch.utils.events import get_event_storage

from _torch_helpers import TINY_IDOL, tiny_batch, ytvis19_r50_cfg


def _state(seed=0):
    """A tiny IDOL in train mode with the ytvis19_r50 optimizer, scheduler and
    clip, and its train step."""
    cfg = ytvis19_r50_cfg()
    model = IDOL(**TINY_IDOL, max_insts=8, dropout=0.1)
    init_weights(model, seed)
    optimizer = solver.build_optimizer(cfg, model)
    state = TrainState.create(model, optimizer, solver.build_lr_scheduler(cfg, optimizer))
    step = make_train_step(model, optimizer, default_weight_dict(dec_layers=2), solver.build_grad_clip(cfg), seed=3)
    return state, step


def _inputs(batch):
    return batch_to_model_inputs(batch, PIXEL_MEAN, PIXEL_STD, "cpu")


def _fake_trainer(losses):
    state = TrainState.create(torch.nn.Linear(2, 2), torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1))

    def step(s, inputs):
        s.step += 1
        return s, {"total_loss": torch.tensor(losses[s.step - 1])}

    return VISTrainer(step, state, iter([tiny_batch(i, n_valid=(1,)) for i in range(len(losses))]), "cpu")



def _assert_state_equal(a: TrainState, b: TrainState):
    assert a.step == b.step
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k in sa["state"][i]:
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)
    assert a.scheduler.state_dict() == b.scheduler.state_dict()


def test_save_writes_the_marker_and_get_checkpoint_file_reads_it(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "out"))
    assert not ckpt.has_checkpoint() and ckpt.get_checkpoint_file() is None
    path = ckpt.save("model_0000004", {"step": 5, "model": {"w": torch.arange(3.0)}})
    assert path == str(tmp_path / "out" / "model_0000004.pth")
    assert (tmp_path / "out" / LAST_CHECKPOINT_FILE).read_text() == "model_0000004.pth"
    assert ckpt.has_checkpoint() and ckpt.get_checkpoint_file() == path
    ckpt.save("model_0000009", {"step": 10, "model": {}})
    assert ckpt.get_checkpoint_file().endswith("model_0000009.pth")
    loaded = ckpt.load(path)
    assert loaded["step"] == 5 and torch.equal(loaded["model"]["w"], torch.arange(3.0))
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        LAST_CHECKPOINT_FILE, "model_0000004.pth", "model_0000009.pth"]


def test_periodic_checkpointer_writes_through_the_checkpointer(tmp_path):
    trainer = _fake_trainer([1.0] * 5)
    trainer.register_hooks([PeriodicCheckpointer(Checkpointer(str(tmp_path)), period=2)])
    trainer.train(0, 5)
    assert sorted(p.name for p in tmp_path.glob("*.pth")) == [
        "model_0000001.pth", "model_0000003.pth", "model_0000004.pth"]
    assert Checkpointer(str(tmp_path)).get_checkpoint_file().endswith("model_0000004.pth")


def test_resumed_run_equals_the_straight_run_bit_for_bit(tmp_path):
    batches = [tiny_batch(i) for i in range(3)]
    straight, step = _state()
    for b in batches:
        straight, _ = step(straight, _inputs(b))

    first, step1 = _state()
    for b in batches[:2]:
        first, _ = step1(first, _inputs(b))
    trainer = VISTrainer(step1, first, iter([]), "cpu")
    Checkpointer(str(tmp_path)).save("model_0000001", trainer.checkpoint_state())

    resumed, step2 = _state(seed=9)                       # other weights, which the resume replaces
    resumed, start_iter = Checkpointer(str(tmp_path)).resume_or_load("", resumed, resume=True)
    assert start_iter == 2
    _assert_state_equal(resumed, first)
    resumed, metrics = step2(resumed, _inputs(batches[2]))
    assert np.isfinite(float(metrics["total_loss"]))
    _assert_state_equal(resumed, straight)


def test_resume_or_load_without_a_checkpoint(tmp_path):
    state, _ = _state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    ckpt = Checkpointer(str(tmp_path))
    state, start = ckpt.resume_or_load("", state, resume=True)      # no marker, no weights
    assert start == 0 and state.step == 0
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())

    # resume=False loads weights only, even where a marker is
    other, _ = _state(seed=4)
    weights = ckpt.save("model_0000000", {"step": 7, "model": other.model.state_dict(),
                                          "optimizer": other.optimizer.state_dict(), "scheduler": None})
    state, start = ckpt.resume_or_load(weights, state, resume=False)
    assert start == 0 and state.step == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, other.model.state_dict()[k]), k
    assert state.optimizer.state_dict()["state"] == {}


def test_reference_pth_goes_through_torch_import(tmp_path):
    source, _ = _state(seed=5)
    want = {k: v.clone() for k, v in source.model.state_dict().items()}
    ref = {f"module.{k}": v for k, v in torch_import.to_reference_names(want, "idol").items()}
    path = tmp_path / "model_final.pth"
    torch.save({"model": ref, "iteration": 90000}, path)
    state, _ = _state(seed=6)
    state, start = Checkpointer(str(tmp_path / "out")).resume_or_load(str(path), state, resume=True)
    assert start == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_missing_weights_file_raises(tmp_path):
    state, _ = _state()
    with pytest.raises(FileNotFoundError, match="cocopretrain_R50.pth"):
        Checkpointer(str(tmp_path)).resume_or_load("cocopretrain_R50.pth", state, resume=False)
    with pytest.raises(FileNotFoundError):
        load_weights(str(tmp_path / "nope.pth"), state.model)


def test_resume_needs_a_matching_scheduler(tmp_path):
    state, _ = _state()
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save("model_0000000", {"step": 1, "model": state.model.state_dict(),
                                "optimizer": state.optimizer.state_dict(), "scheduler": None})
    with pytest.raises(ValueError, match="scheduler"):
        ckpt.resume_or_load("", state, resume=True)


def test_eval_hook_runs_on_its_period_and_after_training():
    """Every period (not at the last step) and once after training, even with
    period 0; its numbers reach the storage under flattened keys."""
    for period, want in ((2, [1, 3, 5]), (0, [5]), (3, [2, 5])):
        trainer = _fake_trainer([1.0] * 5)
        seen = []

        def evaluate():
            seen.append(trainer.iter)
            return {"ds": {"segm": {"AP": 0.25 * len(seen), "name": "not a number"}}}

        trainer.register_hooks([EvalHook(period, evaluate)])
        trainer.train(0, 5)
        assert seen == want, period
        assert trainer.storage.history("ds/segm/AP").values() == [0.25 * i for i in range(1, len(want) + 1)]
        assert "ds/segm/name" not in trainer.storage.histories()


def test_best_checkpointer_saves_on_improvement(tmp_path):
    """``model_best`` is written when the metric improves on its period."""
    values = {1: 0.3, 3: 0.2, 5: 0.5}
    trainer = _fake_trainer([1.0] * 6)

    class Metric(HookBase):
        def after_step(self):
            if self.trainer.iter in values:
                get_event_storage().put_scalar("segm/AP", values[self.trainer.iter], smoothing_hint=False)

    ckpt = Checkpointer(str(tmp_path))
    saved = []
    orig = ckpt.save
    ckpt.save = lambda name, state: saved.append((name, trainer.iter)) or orig(name, state)
    trainer.register_hooks([Metric(), BestCheckpointer(2, ckpt, "segm/AP")])
    trainer.train(0, 6)
    assert saved == [("model_best", 1), ("model_best", 5)]
    assert ckpt.get_checkpoint_file().endswith("model_best.pth")
    with pytest.raises(ValueError, match="mode"):
        BestCheckpointer(2, ckpt, "segm/AP", mode="median")
