"""The port's entry point (``vnext_tpu_torch.tools.train_net``) against the JAX
package's ``tools/train_net.py``, on the CPU with the quick-schedule config
(``configs/quick_schedules/idol_instant_test.yaml``: IDOL on ResNet-18, hidden
64, 24 queries, 1 + 2 layers, the synthetic YTVIS dataset) and
``MODEL.DEVICE cpu``.

- ``--eval-only``: the JAX ``do_eval`` (the script loaded by path) and the
  port's, on JAX's ``PRNGKey(0)`` parameters carried across with
  ``checkpoint/from_jax.py``, in f32 (``TPU.COMPUTE_DTYPE float32``), give
  the same ``results.json`` entries and the same AP dict. At random weights
  every query scores ~0.01 and no track is born, so the last class head's bias
  of class 0 is raised in both trees (to 0.3 for the median query) so that
  the tracker, the masks, the writer and the AP have real work. Scores agree
  to float32 rounding (rtol 1e-5); labels, video ids and every RLE mask are
  held equal.
- Training: the port's ``do_train`` for 3 iterations writes ``metrics.json``,
  the checkpoints and ``last_checkpoint``, with a finite final loss under
  ``TEST.FINAL_LOSS_BOUND``; ``--resume`` continues from the marker.
- Two runs of ``main`` in one process each write ``log.txt`` into their own
  output directory; the synthetic dataset is generated only for a config that
  names it.
- IDOL's COCO-pretrain stage (``INPUT.COCO_PRETRAIN True``) on the synthetic
  COCO set: 3 steps, then ``--resume``; every batch the trainer takes is equal
  to the JAX package's loader with its ``CocoClipDatasetMapper`` for the same
  seed, bit for bit.
- Training refuses, before it builds the model, a ``DATASETS.TEST`` set that
  the evaluation after the last step could not score: a COCO-type set (IDOL's
  video path cannot score it) or one with fewer categories than the model
  predicts.
- ``main`` refuses to train an image meta-architecture (Mask R-CNN serves
  through it: tests/test_torch_detection.py), more than one GPU or process,
  and a run on the card when no CUDA device is visible; ``--eval-only`` with
  ``TPU.FUSED_TRACKER True`` runs the on-device tracker.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.config import add_idol_config as jax_add_idol_config
from vnext_tpu.config import get_cfg as jax_get_cfg
from vnext_tpu.data.build import build_vis_train_loader as jax_build_vis_train_loader
from vnext_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from vnext_tpu.data.coco_clip_mapper import CocoClipDatasetMapper as JaxCocoMapper
from vnext_tpu.data.datasets.synthetic import register_synthetic_coco as jax_register_synthetic_coco
from vnext_tpu.data.datasets.synthetic import register_synthetic_ytvis as jax_register_synthetic_ytvis
from vnext_tpu.models.idol import IDOL as JaxIDOL
from vnext_tpu.models.idol import build_idol_model as jax_build_idol_model
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_coco, register_synthetic_ytvis
from vnext_tpu_torch.models.idol import build_idol_model
from vnext_tpu_torch.tools import train_net

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANT = os.path.join(REPO, "configs", "quick_schedules", "idol_instant_test.yaml")


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """Both packages' "ytvis_synthetic_tiny" registered on the same files under
    a temporary root (the one the JAX catalog already has in this process, if
    another test registered it first)."""
    jax_register_synthetic_ytvis(root=str(tmp_path_factory.mktemp("synth") / "ytvis_synthetic_tiny"))
    root = os.path.dirname(JaxMetadataCatalog.get("ytvis_synthetic_tiny").json_file)
    register_synthetic_ytvis(root=root)
    return root


def _jax_train_net():
    spec = importlib.util.spec_from_file_location("jax_train_net", os.path.join(REPO, "tools", "train_net.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _args(parser, *argv):
    return parser().parse_args(["--config-file", INSTANT, *argv])


def test_eval_only_equals_jax(synthetic, tmp_path):
    jax_tn = _jax_train_net()
    opts = ["--eval-only", "TPU.COMPUTE_DTYPE", "float32", "MODEL.WEIGHTS", ""]
    jcfg = jax_tn.setup(_args(jax_tn.default_argument_parser, *opts, "OUTPUT_DIR", str(tmp_path / "jax")))
    cfg = train_net.setup(_args(train_net.default_argument_parser, *opts, "MODEL.DEVICE", "cpu",
                                "OUTPUT_DIR", str(tmp_path / "port")))

    # JAX's do_eval's own initialization (under jit: eager, flax compiles it op by op), then class 0
    # raised so that tracks are born
    h, w = jcfg.TPU.TEST_IMAGE_SIZE
    jmodel = jax_build_idol_model(jcfg)
    params = jax.jit(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, h, w, 3)),
                                         jnp.asarray([[h, w]], jnp.int32), method=JaxIDOL.inference)["params"])()
    params = jax.tree.map(np.asarray, params)
    last = f"class_embed_{jcfg.MODEL.IDOL.DEC_LAYERS - 1}"
    bias = params[last]["bias"].copy()
    bias[0] += np.log(0.3 / 0.7) - bias[0]
    params = {**params, last: {**params[last], "bias": bias}}

    want = jax_tn.do_eval(jcfg, jax.tree.map(jnp.asarray, params))
    model = build_idol_model(cfg, device="cpu")
    load_from_jax(model, params)
    model.train()                                       # do_eval runs it in eval mode and puts it back
    got = train_net.do_eval(cfg, model)
    assert model.training

    with open(tmp_path / "port" / "results.json") as f, open(tmp_path / "jax" / "results.json") as g:
        got_entries, want_entries = json.load(f), json.load(g)
    assert len(want_entries) > 0, "the raised class must give tracks"
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


def test_train_checkpoints_and_resumes(synthetic, tmp_path):
    out = str(tmp_path / "out")
    base = ["--config-file", INSTANT, "MODEL.DEVICE", "cpu", "OUTPUT_DIR", out, "TEST.FINAL_LOSS_BOUND", "1e4",
            "SOLVER.CHECKPOINT_PERIOD", "2"]
    trainer = train_net.main(base)
    assert trainer.iter == 3 and trainer.state.step == 3
    hist = trainer.storage.history("total_loss")
    assert hist.count() == 3 and np.isfinite(hist.values()).all()
    lines = [json.loads(line) for line in open(os.path.join(out, "metrics.json"))]
    # the writer's period (20) exceeds the run: it writes at the last step and after training, the
    # metrics one step late (the last step's at iteration 3)
    assert [r["iteration"] for r in lines if "total_loss" in r] == [2, 3]
    # the end-of-training evaluation (EvalHook.after_train, TEST.EVAL_PERIOD 0) reached the storage
    assert any("ytvis_synthetic_tiny/segm/AP" in r for r in lines)
    assert open(os.path.join(out, "last_checkpoint")).read() == "model_0000002.pth"
    assert sorted(f for f in os.listdir(out) if f.endswith(".pth")) == ["model_0000001.pth", "model_0000002.pth"]
    assert os.path.exists(os.path.join(out, "results.json")) and os.path.exists(os.path.join(out, "config.yaml"))

    resumed = train_net.main(["--resume", *base, "SOLVER.MAX_ITER", "5"])
    assert resumed.start_iter == 3 and resumed.iter == 5 and resumed.state.step == 5
    assert open(os.path.join(out, "last_checkpoint")).read() == "model_0000004.pth"
    # the optimizer continued where the checkpoint left it: the schedule's rate of step 5
    lr = train_net.build_lr_schedule(train_net.setup(train_net.default_argument_parser().parse_args(base)))(5)
    assert resumed.state.optimizer.param_groups[1]["lr"] == pytest.approx(lr, rel=1e-12)


@pytest.fixture(scope="module")
def synthetic_coco(tmp_path_factory):
    """Both packages' "coco_synthetic_tiny" (8 images at 160x224) on the same
    files, as ``synthetic`` does for the YTVIS set."""
    jax_register_synthetic_coco(root=str(tmp_path_factory.mktemp("synth") / "coco_synthetic_tiny"))
    root = os.path.dirname(JaxMetadataCatalog.get("coco_synthetic_tiny").json_file)
    register_synthetic_coco(root=root)
    return root


def test_coco_pretrain_trains_and_resumes(synthetic, synthetic_coco, tmp_path, monkeypatch):
    taken = []
    build_loader = train_net.build_vis_train_loader

    def recording_loader(*args, **kwargs):
        loader = build_loader(*args, **kwargs)
        return (taken.append(b) or b for b in loader)

    monkeypatch.setattr(train_net, "build_vis_train_loader", recording_loader)
    opts = ["INPUT.COCO_PRETRAIN", "True", "DATASETS.TRAIN", "('coco_synthetic_tiny',)"]
    base = ["--config-file", INSTANT, "MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(tmp_path), "TEST.FINAL_LOSS_BOUND",
            "1e4", "SOLVER.CHECKPOINT_PERIOD", "2", *opts]
    trainer = train_net.main(base)
    assert trainer.iter == 3 and trainer.state.step == 3
    assert np.isfinite(trainer.storage.history("total_loss").values()).all()
    assert (tmp_path / "last_checkpoint").read_text() == "model_0000002.pth"
    straight = list(taken)
    assert len(straight) >= 3

    jcfg = jax_get_cfg()
    jax_add_idol_config(jcfg)
    jcfg.merge_from_file(INSTANT)
    jcfg.merge_from_list(opts)
    want = jax_build_vis_train_loader(jcfg, mapper=JaxCocoMapper.from_config(jcfg), seed=max(jcfg.SEED, 0))
    for step, batch in enumerate(straight):
        jbatch = next(want)
        assert set(batch) == set(jbatch), step
        for k, v in jbatch.items():
            assert batch[k].dtype == v.dtype and np.array_equal(batch[k], v), (step, k)
    assert straight[0]["key_valid"].any()

    taken.clear()
    resumed = train_net.main(["--resume", *base, "SOLVER.MAX_ITER", "5"])
    assert resumed.start_iter == 3 and resumed.iter == 5 and resumed.state.step == 5
    assert (tmp_path / "last_checkpoint").read_text() == "model_0000004.pth"
    # a resumed run starts the loader again from its seed, as the JAX package's does
    for a, b in zip(taken, straight):
        assert all(np.array_equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("opts, error, match", [
    (["INPUT.COCO_PRETRAIN", "True", "DATASETS.TRAIN", "('coco_synthetic_tiny',)", "DATASETS.TEST",
      "('coco_synthetic_tiny',)"], NotImplementedError, "no evaluator for type 'coco'"),
    (["MODEL.IDOL.NUM_CLASSES", "80"], ValueError, "'ytvis_synthetic_tiny' has 3 categories"),
], ids=["coco_evaluator", "fewer_categories"])
def test_train_refuses_a_test_set_it_cannot_score_before_the_first_step(synthetic, synthetic_coco, tmp_path,
                                                                         monkeypatch, opts, error, match):
    def no_model(*args, **kwargs):
        raise AssertionError("a model was built before the test sets were checked")

    monkeypatch.setattr(train_net, "build_idol_model", no_model)
    with pytest.raises(error, match=match):
        train_net.main(["--config-file", INSTANT, "MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(tmp_path), *opts])
    assert not (tmp_path / "metrics.json").exists() and not (tmp_path / "last_checkpoint").exists()
    # with no test set there is nothing to score
    cfg = train_net.setup(_args(train_net.default_argument_parser, *opts, "DATASETS.TEST", "()",
                                "OUTPUT_DIR", str(tmp_path)))
    assert cfg.DATASETS.TEST == ()
    train_net._check_test_sets(cfg)


def test_each_run_logs_into_its_own_output_dir(synthetic, tmp_path):
    for run in ("first", "second"):
        train_net.main(["--config-file", INSTANT, "--eval-only", "MODEL.DEVICE", "cpu",
                        "OUTPUT_DIR", str(tmp_path / run)])
    for run in ("first", "second"):
        log = (tmp_path / run / "log.txt").read_text()
        assert f"results written to {tmp_path / run}/results.json" in log, run
        assert str(tmp_path / ("second" if run == "first" else "first")) not in log, run


def test_synthetic_dataset_only_where_the_config_names_it(monkeypatch, tmp_path):
    made = []
    monkeypatch.setattr(train_net, "register_synthetic_ytvis", made.append)
    cfg = train_net.setup(_args(train_net.default_argument_parser, "DATASETS.TRAIN", "('ytvis_2019_train',)",
                                "DATASETS.TEST", "('ytvis_2019_val',)", "OUTPUT_DIR", str(tmp_path)))
    train_net._register_datasets(cfg)
    assert made == []
    train_net._register_datasets(train_net.setup(_args(train_net.default_argument_parser,
                                                        "OUTPUT_DIR", str(tmp_path))))
    assert made == ["ytvis_synthetic_tiny"]


def test_main_refuses_what_the_port_lacks(synthetic, tmp_path, monkeypatch):
    out = ["OUTPUT_DIR", str(tmp_path)]
    rcnn = os.path.join(REPO, "configs", "quick_schedules", "mask_rcnn_R_18_instant_test.yaml")
    with pytest.raises(NotImplementedError, match="Queue 1, item 11b"):     # Mask R-CNN serves, but does not train
        train_net.main(["--config-file", rcnn, *out])
    for flag in (["--num-gpus", "2"], ["--machine-rank", "1"], ["--dist-url", "tcp://127.0.0.1:29500"]):
        with pytest.raises(NotImplementedError, match="item 12"):
            train_net.main(["--config-file", INSTANT, *flag, "MODEL.DEVICE", "cpu", *out])
    # the on-device tracker is ported: --eval-only runs through it on the CPU
    fused = train_net.main(["--config-file", INSTANT, "--eval-only", "MODEL.DEVICE", "cpu", "TPU.FUSED_TRACKER",
                            "True", *out])
    assert list(fused) == ["ytvis_synthetic_tiny"] and "AP" in fused["ytvis_synthetic_tiny"]["segm"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("tpu", "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device is visible"):
            train_net.main(["--config-file", INSTANT, "--eval-only", "MODEL.DEVICE", device, *out])
    with pytest.raises(ValueError, match="MODEL.DEVICE"):
        train_net.main(["--config-file", INSTANT, "--eval-only", "MODEL.DEVICE", "mps", *out])
