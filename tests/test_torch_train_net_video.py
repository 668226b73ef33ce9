"""The port's MinVIS entry point (``vnext_tpu_torch.tools.train_net_video``)
against the JAX package's ``tools/train_net_video.py``, on the CPU with the
quick-schedule config (``configs/quick_schedules/minvis_instant_test.yaml``:
MaskFormer on ResNet-18, hidden 64, 16 queries, 1 + 2 layers, 256 sampled
points, the synthetic YTVIS dataset) and ``MODEL.DEVICE cpu``.

- ``--eval-only``: the JAX ``do_eval`` (the script loaded by path) and the
  port's, on one random tree of JAX do_eval's model (``random_params``: no
  init is compiled) carried across with
  ``checkpoint/from_jax.py``, in f32, give the same ``results.json`` entries
  (labels, video ids and RLE masks equal, scores to rtol 1e-5) and the same
  AP dict.
- The batch adapter: the port's tensors equal JAX's ``_minvis_batch_adapter``
  output on one collated batch of the loader.
- Training: 3 iterations through ``main`` write the checkpoints and
  ``metrics.json`` with a finite final loss; ``--resume`` continues from the
  marker at the schedule's rate. The loader starts again on a resume (in both
  packages), so the bit-for-bit check is on the steps: 2 steps, a save and a
  resume into a fresh model, then the third step, equal to 3 straight steps on
  the same batches, the point draws included.
- ``MODEL.INSTMOVE.ENABLED`` at the runner's frame size (480x864: 120x216
  masks, sides not multiples of 16) raises a ``ValueError`` before any video;
  tests/test_torch_minvis_inference.py holds both packages failing at
  90x160 and 120x216.
- Without a card the entry point raises unless asked for the CPU (a launch
  of two processes on cards too), and it refuses another meta-architecture;
  the distribution flags of a world of one process run straight through.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from vnext_tpu.data.datasets.synthetic import register_synthetic_ytvis as jax_register_synthetic_ytvis
from vnext_tpu.models.mask2former import MaskFormer as JaxMaskFormer
from vnext_tpu.models.mask2former import build_maskformer_model as jax_build_maskformer_model
from vnext_tpu_torch.checkpoint.checkpointer import Checkpointer
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.data import build_vis_train_loader
from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_ytvis
from vnext_tpu_torch.engine.train_step import TrainState, make_train_step
from vnext_tpu_torch.models.mask2former import build_maskformer_model, maskformer_weight_dict
from vnext_tpu_torch.solver.build import build_grad_clip, build_lr_scheduler, build_optimizer
from vnext_tpu_torch.tools import train_net_video as tv
from vnext_tpu_torch.tools.train_net import default_argument_parser

from _torch_helpers import random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANT = os.path.join(REPO, "configs", "quick_schedules", "minvis_instant_test.yaml")


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """Both packages' "ytvis_synthetic_tiny" on the same files (the root the
    JAX catalog already has in this process, if another test registered it)."""
    jax_register_synthetic_ytvis(root=str(tmp_path_factory.mktemp("synth") / "ytvis_synthetic_tiny"))
    root = os.path.dirname(JaxMetadataCatalog.get("ytvis_synthetic_tiny").json_file)
    register_synthetic_ytvis(root=root)
    return root


def _jax_train_net_video():
    spec = importlib.util.spec_from_file_location("jax_train_net_video",
                                                  os.path.join(REPO, "tools", "train_net_video.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cfg(module, *opts):
    parser = (default_argument_parser if module is tv else module.default_argument_parser)()
    return module.setup(parser.parse_args(["--config-file", INSTANT, *opts]))


def test_eval_only_equals_jax(synthetic, tmp_path):
    jax_tv = _jax_train_net_video()
    opts = ["TPU.COMPUTE_DTYPE", "float32"]
    jcfg = _cfg(jax_tv, "--eval-only", *opts, "OUTPUT_DIR", str(tmp_path / "jax"))
    cfg = _cfg(tv, "--eval-only", *opts, "MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(tmp_path / "port"))

    # a random tree of the model JAX do_eval builds (its init, even under jit, compiles for ~13 s)
    h, w = jcfg.TPU.TRAIN_IMAGE_SIZE
    jmodel = jax_build_maskformer_model(jcfg)
    params = random_params(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, h, w, 3)),
                                               jnp.asarray([[h, w]], jnp.int32), method=JaxMaskFormer.inference))
    want = jax_tv.do_eval(jcfg, jax.tree.map(jnp.asarray, params))

    model = build_maskformer_model(cfg, device="cpu")
    load_from_jax(model, params)
    model.train()                                       # do_eval runs it in eval mode and puts it back
    got = tv.do_eval(cfg, model)
    assert model.training

    with open(tmp_path / "port" / "results.json") as f, open(tmp_path / "jax" / "results.json") as g:
        got_entries, want_entries = json.load(f), json.load(g)
    assert len(want_entries) == 20                      # the top 10 of each of the 2 videos
    assert len(got_entries) == len(want_entries)
    for a, b in zip(got_entries, want_entries):
        assert (a["video_id"], a["category_id"]) == (b["video_id"], b["category_id"])
        assert a["segmentations"] == b["segmentations"]
        np.testing.assert_allclose(a["score"], b["score"], rtol=1e-5)
    assert list(got) == list(want) == ["ytvis_synthetic_tiny"]
    stats, want_stats = got["ytvis_synthetic_tiny"]["segm"], want["ytvis_synthetic_tiny"]["segm"]
    assert set(stats) == set(want_stats)
    for k in stats:
        assert (np.isnan(stats[k]) and np.isnan(want_stats[k])) or stats[k] == want_stats[k], k


def test_batch_adapter_equals_jax(synthetic, tmp_path):
    jax_tv = _jax_train_net_video()
    cfg = _cfg(tv, "MODEL.DEVICE", "cpu", "SOLVER.IMS_PER_BATCH", "2", "OUTPUT_DIR", str(tmp_path))
    batch = next(build_vis_train_loader(cfg, seed=0))
    want = jax_tv._minvis_batch_adapter(cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD)(batch)
    got = tv.minvis_batch_adapter(cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, "cpu")(batch)
    assert got[0].shape[0] == 4                           # 2 clips x (key + ref)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_train_checkpoints_and_resumes(synthetic, tmp_path):
    out = str(tmp_path / "out")
    base = ["--config-file", INSTANT, "MODEL.DEVICE", "cpu", "OUTPUT_DIR", out, "TEST.FINAL_LOSS_BOUND", "1e4",
            "SOLVER.CHECKPOINT_PERIOD", "2"]
    trainer = tv.main(base)
    assert trainer.iter == 3 and trainer.state.step == 3
    hist = trainer.storage.history("total_loss")
    assert hist.count() == 3 and np.isfinite(hist.values()).all()
    lines = [json.loads(line) for line in open(os.path.join(out, "metrics.json"))]
    assert any("loss_mask_1" in r for r in lines)
    assert any("ytvis_synthetic_tiny/segm/AP" in r for r in lines)       # the end-of-training evaluation
    assert open(os.path.join(out, "last_checkpoint")).read() == "model_0000002.pth"

    resumed = tv.main(["--resume", *base, "SOLVER.MAX_ITER", "4"])
    assert resumed.start_iter == 3 and resumed.iter == 4 and resumed.state.step == 4
    lr = tv.build_lr_schedule(tv.setup(default_argument_parser().parse_args(base)))(4)
    assert resumed.state.optimizer.param_groups[1]["lr"] == pytest.approx(lr, rel=1e-12)


def test_resumed_steps_equal_straight_steps_bit_for_bit(synthetic, tmp_path):
    """The entry point's pieces (its model, optimizer, schedule, clip, weights,
    batch adapter and step with its point draws): 3 straight steps against 2
    steps, a save, a resume into another model and the third step."""
    cfg = _cfg(tv, "MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(tmp_path))
    adapter = tv.minvis_batch_adapter(cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, "cpu")
    loader = build_vis_train_loader(cfg, seed=0)
    batches = [adapter(next(loader)) for _ in range(3)]

    def fresh(seed):
        model = build_maskformer_model(cfg, device="cpu", seed=seed)
        optimizer = build_optimizer(cfg, model)
        step = make_train_step(model, optimizer, maskformer_weight_dict(cfg), build_grad_clip(cfg))
        return TrainState.create(model, optimizer, build_lr_scheduler(cfg, optimizer)), step

    straight, step = fresh(0)
    for b in batches:
        straight, _ = step(straight, b)
    first, step = fresh(0)
    for b in batches[:2]:
        first, _ = step(first, b)
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save("model_0000001", {"step": first.step, "model": first.model.state_dict(),
                                "optimizer": first.optimizer.state_dict(),
                                "scheduler": first.scheduler.state_dict()})
    resumed, step = fresh(7)
    resumed, start = ckpt.resume_or_load("", resumed, resume=True)
    assert start == 2 and resumed.step == 2
    resumed, _ = step(resumed, batches[2])
    assert resumed.step == straight.step == 3
    for (n, a), b in zip(resumed.model.state_dict().items(), straight.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert resumed.scheduler.state_dict() == straight.scheduler.state_dict()


def test_motion_at_the_runner_size_raises_before_any_video(synthetic, tmp_path, monkeypatch):
    cfg = _cfg(tv, "--eval-only", "MODEL.DEVICE", "cpu", "MODEL.INSTMOVE.ENABLED", "True",
               "MODEL.INSTMOVE.MEMORY_SIZE", "8", "MODEL.INSTMOVE.LSTM_CHANNELS", "16",
               "MODEL.INSTMOVE.LSTM_LAYERS", "1", "OUTPUT_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(tv, "inference_on_dataset", lambda *a: calls.append(a))
    with pytest.raises(ValueError, match="120x216 masks"):
        tv.do_eval(cfg)
    assert calls == []


def test_main_refuses_what_the_port_lacks(synthetic, tmp_path, monkeypatch):
    out = ["OUTPUT_DIR", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="train_net"):
        tv.main(["--config-file", INSTANT, "--eval-only", "MODEL.DEVICE", "cpu", "MODEL.META_ARCHITECTURE", "IDOL",
                 *out])
    # a world of one process calls straight through: the architecture check runs, with no group
    with pytest.raises(NotImplementedError, match="train_net"):
        tv.main(["--config-file", INSTANT, "--num-gpus", "1", "--machine-rank", "0", "--dist-url",
                 "tcp://127.0.0.1:29500", "--eval-only", "MODEL.DEVICE", "cpu", "MODEL.META_ARCHITECTURE", "IDOL",
                 *out])
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        tv.main(["--config-file", INSTANT, "--num-gpus", "2", *out])
    for device in ("tpu", "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            tv.main(["--config-file", INSTANT, "--eval-only", "MODEL.DEVICE", device, *out])
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            tv.main(["--config-file", INSTANT, "MODEL.DEVICE", device, *out])
