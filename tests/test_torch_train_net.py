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
- ``main`` refuses an image meta-architecture, ``INPUT.COCO_PRETRAIN``, more
  than one GPU or process, and a run on the card when no CUDA device is
  visible; ``--eval-only`` with ``TPU.FUSED_TRACKER True`` runs the on-device
  tracker.
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
from vnext_tpu.models.idol import IDOL as JaxIDOL
from vnext_tpu.models.idol import build_idol_model as jax_build_idol_model
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_ytvis
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

    # JAX's do_eval's own initialization, then class 0 raised so that tracks are born
    h, w = jcfg.TPU.TEST_IMAGE_SIZE
    jmodel = jax_build_idol_model(jcfg)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, h, w, 3)),
                         jnp.asarray([[h, w]], jnp.int32), method=JaxIDOL.inference)["params"]
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
    with pytest.raises(NotImplementedError, match="Queue 1, item 11"):
        train_net.main(["--config-file", rcnn, "--eval-only", *out])
    with pytest.raises(NotImplementedError, match="COCO_PRETRAIN"):
        train_net.main(["--config-file", INSTANT, "MODEL.DEVICE", "cpu", "INPUT.COCO_PRETRAIN", "True", *out])
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
