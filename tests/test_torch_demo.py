"""The slice as a whole on the CPU: the port's tools against the JAX package's.

- The demo: JAX's ``demo/demo.py`` (loaded by path, as ``tests/test_demo.py``
  loads it) and ``vnext_tpu_torch.tools.demo`` on the same 3 frames of
  ``idol_instant_test.yaml`` (f32, frames and test size 64x96). The port gets
  the JAX demo's own parameters, through
  ``checkpoint/from_jax.py`` and a ``MODEL.WEIGHTS`` file; the last class
  head's class-0 bias is raised in both (as chip_smoke's phase 3 does) so that
  random weights make tracks. The runners' labels are equal, their scores
  within 1e-4 and their masks agree on >= 99.9% of pixels (the tolerances of
  ``tests/test_torch_video_inference.py``: f32 on both sides, a pixel flips
  only where a probability sits at 0.5 to f32 rounding), and the written frames
  agree on >= 99.5% of pixels (the rest at the mask borders those flips move).
  The JAX demo's parameter init is replaced by ``random_params`` (its eager
  init compiles op by op, ~45 s; under ``jax.jit`` it still compiles once):
  the port takes whatever parameters the JAX demo made.
- ``visualize_data`` / ``visualize_json_results``: the same images as JAX's
  tools on one synthetic YTVIS set.
- ``plain_train_net``: the same losses, step by step, as ``train_net``'s
  ``VISTrainer`` on the same seed and batches; ``lazyconfig_train_net``
  without ``train.entry`` exits as JAX's does, and with the example's entry
  trains.
- Every tool that builds a model refuses the card when none is visible.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vnext_tpu.data import DatasetCatalog as JaxDatasetCatalog
from vnext_tpu.data.datasets.ytvis import register_ytvis_instances as jax_register_ytvis
from vnext_tpu.models.idol import IDOL as JaxIDOL
from vnext_tpu_torch.checkpoint.from_jax import params_from_jax
from vnext_tpu_torch.data import DatasetCatalog
from vnext_tpu_torch.data.datasets.synthetic import THING_CLASSES, register_synthetic_ytvis
from vnext_tpu_torch.tools import (analyze_model, demo, export_model, lazyconfig_train_net, plain_train_net,
                                   train_net, visualize_data, visualize_json_results)
from vnext_tpu_torch.utils.video_io import VideoWriter, read_mjpeg_avi

from _torch_helpers import random_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK = os.path.join(REPO, "configs", "quick_schedules", "idol_instant_test.yaml")
SMALL = ["TPU.COMPUTE_DTYPE", "float32", "TPU.TEST_IMAGE_SIZE", "[64, 96]", "INPUT.MIN_SIZE_TEST", "64",
         "INPUT.MAX_SIZE_TEST", "96"]
CLASS_SHIFT = 5.0      # sigmoid(-4.6 + 5) ~ 0.6: tracks are born and drawn at the demo's 0.3


def _load_by_path(name, rel):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(seed, n=3):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 40, (n, 64, 96, 3)).astype(np.uint8)
    for o in range(3):
        y, x, color = rng.randint(0, 30), rng.randint(0, 50), rng.randint(80, 256, 3)
        for i in range(n):
            frames[i, y + i:y + i + 24, x + 2 * i:x + 2 * i + 30] = color
    return frames


@pytest.fixture(scope="module")
def both_demos(tmp_path_factory):
    from vnext_tpu.engine import vis_inference as jax_vis_inference

    root = tmp_path_factory.mktemp("demo")
    os.makedirs(root / "frames")
    for i, fr in enumerate(_frames(0)):
        Image.fromarray(fr).save(root / "frames" / f"{i:03d}.png")
    captured = {}

    class Recording(jax_vis_inference.IDOLVideoInference):
        def __init__(self, model, params, **kwargs):
            last = f"class_embed_{model.dec_layers - 1}"
            params = {**params, last: {**params[last], "bias": params[last]["bias"].at[0].add(CLASS_SHIFT)}}
            captured["params"] = params
            super().__init__(model, params, **kwargs)

        def __call__(self, record):
            captured["jax_out"] = super().__call__(record)
            return captured["jax_out"]

    init = JaxIDOL.init

    def shaped_init(self, rngs, *args, method=None, **kwargs):
        return {"params": jax.tree.map(jnp.asarray, random_params(
            lambda: init(self, rngs, *args, method=method, **kwargs)))}

    jax_demo = _load_by_path("jax_demo_for_port", "demo/demo.py")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_vis_inference, "IDOLVideoInference", Recording)
        mp.setattr(JaxIDOL, "init", shaped_init)
        mp.setattr(sys, "argv", ["demo.py", "--config-file", QUICK, "--input", str(root / "frames"),
                                 "--output", str(root / "jax"), *SMALL])
        jax_demo.main()
    weights = str(root / "jax_params.pth")
    torch.save(params_from_jax(jax.tree.map(np.asarray, captured["params"])), weights)
    port = demo.main(["--config-file", QUICK, "--input", str(root / "frames"), "--output", str(root / "port"),
                      *SMALL, "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", weights])
    return root, weights, captured["jax_out"], port


def test_demo_runner_outputs_equal_jax(both_demos):
    _, _, want, port = both_demos
    got = port["output"]
    assert port["frames"] == 3
    assert len(want["pred_scores"]) > 0, "the demo must make tracks"
    assert got["pred_labels"] == want["pred_labels"]
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], atol=1e-4, rtol=0)
    for inst_g, inst_w in zip(got["pred_masks"], want["pred_masks"]):
        assert [m is None for m in inst_g] == [m is None for m in inst_w]
        for mg, mw in zip(inst_g, inst_w):
            if mw is not None:
                assert mg.shape == mw.shape == (64, 96)
                assert float((np.asarray(mg, bool) == np.asarray(mw, bool)).mean()) >= 0.999


def test_demo_writes_jax_frames(both_demos):
    root, _, want, _ = both_demos
    names = sorted(os.listdir(root / "jax"))
    assert names == sorted(os.listdir(root / "port")) and len(names) == 3
    drawn = sum(s >= 0.3 for s in want["pred_scores"])
    assert drawn > 0, "the frames must have tracks drawn on them"
    for name in names:
        a = np.asarray(Image.open(root / "jax" / name))
        b = np.asarray(Image.open(root / "port" / name))
        assert a.shape == b.shape == (64, 96, 3)
        assert float((a == b).all(-1).mean()) >= 0.995, name


def test_demo_video_input_and_what_it_refuses(both_demos, monkeypatch):
    root, weights, _, _ = both_demos
    with VideoWriter(str(root / "clip.avi"), fps=10.0) as vw:
        for fr in _frames(1):
            vw.write(fr)
    args = ["--config-file", QUICK, *SMALL, "MODEL.DEVICE", "cpu", "MODEL.WEIGHTS", weights]
    res = demo.main(["--video-input", str(root / "clip.avi"), "--video-output", str(root / "vis.avi"), *args])
    frames, fps = read_mjpeg_avi(str(root / "vis.avi"))
    assert res["frames"] == len(frames) == 3 and abs(fps - 10.0) < 0.01 and frames[0].shape == (64, 96, 3)
    with pytest.raises(SystemExit, match="required"):
        demo.main(["--output", str(root / "x"), *args])
    with pytest.raises(ValueError, match="--model-type seqformer runs SeqFormer"):
        demo.main(["--model-type", "seqformer", "--config-file", QUICK.replace("idol_", "seqformer_"), "--input",
                   str(root / "frames"), "--output", str(root / "x"), "MODEL.META_ARCHITECTURE", "IDOL",
                   "MODEL.DEVICE", "cpu"])
    monkeypatch.setitem(sys.modules, "cv2", None)       # cv2 not installed
    with pytest.raises(RuntimeError, match="cv2"):
        demo.main(["--webcam", "--webcam-max-frames", "2", *args])


def _synthetic_set(tmp_path):
    """One synthetic YTVIS set (the port's files) registered in both catalogs."""
    name = f"ytvis_synthetic_tools_{os.getpid()}"
    register_synthetic_ytvis(name, root=str(tmp_path / "data"), num_videos=2, num_frames=4)
    if name not in JaxDatasetCatalog.list():
        jax_register_ytvis(name, {"thing_classes": list(THING_CLASSES)}, str(tmp_path / "data" / "instances.json"),
                           str(tmp_path / "data" / "JPEGImages"))
    return name


def _same_images(a, b):
    names = sorted(os.listdir(a))
    assert names and names == sorted(os.listdir(b))
    for n in names:
        if os.path.isdir(os.path.join(a, n)):
            _same_images(os.path.join(a, n), os.path.join(b, n))
        else:
            assert np.array_equal(np.asarray(Image.open(os.path.join(a, n))), np.asarray(Image.open(os.path.join(b, n))))


def test_visualize_tools_write_jax_images(tmp_path, monkeypatch):
    import json

    from vnext_tpu_torch.data.dataset_mapper import decode_segmentation
    from vnext_tpu_torch.evaluation.rle import rle_encode

    name = _synthetic_set(tmp_path)
    jax_data = _load_by_path("jax_visualize_data", "tools/visualize_data.py")
    jax_json = _load_by_path("jax_visualize_json_results", "tools/visualize_json_results.py")
    for source in ("annotation", "dataloader"):
        argv = ["--dataset", name, "--source", source, "--max-videos", "2"]
        monkeypatch.setattr(sys, "argv", ["visualize_data.py", *argv, "--output", str(tmp_path / f"jax_{source}")])
        jax_data.main()
        visualize_data.main([*argv, "--output", str(tmp_path / f"port_{source}")])
        _same_images(tmp_path / f"jax_{source}", tmp_path / f"port_{source}")

    results = []
    for rec in DatasetCatalog.get(name):
        ids = sorted({a["id"] for objs in rec["annotations"] for a in objs})
        for k, inst in enumerate(ids):
            segs = []
            for objs in rec["annotations"]:
                seg = next((a["segmentation"] for a in objs if a["id"] == inst), None)
                segs.append(None if seg is None else rle_encode(decode_segmentation(seg, rec["height"], rec["width"])))
            results.append({"video_id": rec["video_id"], "score": 0.9 - 0.2 * k, "category_id": 1 + k % 3,
                            "segmentations": segs})
    with open(tmp_path / "results.json", "w") as f:
        json.dump(results, f)
    argv = ["--input", str(tmp_path / "results.json"), "--dataset", name]
    monkeypatch.setattr(sys, "argv", ["visualize_json_results.py", *argv, "--output", str(tmp_path / "jax_json")])
    jax_json.main()
    visualize_json_results.main([*argv, "--output", str(tmp_path / "port_json")])
    _same_images(tmp_path / "jax_json", tmp_path / "port_json")


def test_plain_train_net_losses_equal_vistrainer(tmp_path):
    common = ["--config-file", QUICK, "MODEL.DEVICE", "cpu", "DATASETS.TEST", "()", "SOLVER.MAX_ITER", "2"]
    trainer = train_net.main([*common, "OUTPUT_DIR", str(tmp_path / "vis_trainer")])
    state, history = plain_train_net.main([*common, "OUTPUT_DIR", str(tmp_path / "plain")])
    assert state.step == len(history) == 2
    storage = trainer.storage
    for key in history[0]:
        assert [h[key] for h in history] == storage.history(key).values(), key
    assert os.path.exists(tmp_path / "plain" / "model_0000002.pth")
    assert (tmp_path / "plain" / "last_checkpoint").read_text() == "model_0000002.pth"
    # --resume continues from the last checkpoint: nothing left to train
    state, history = plain_train_net.main(["--resume", *common, "OUTPUT_DIR", str(tmp_path / "plain")])
    assert state.step == 2 and history == []


def test_lazyconfig_train_net_needs_an_entry_as_jax(tmp_path, monkeypatch):
    cfg = tmp_path / "no_entry.py"
    cfg.write_text(f'model = {{"_target_": "collections.OrderedDict"}}\ntrain = {{"output_dir": "{tmp_path / "out"}"}}\n')
    jax_tool = _load_by_path("jax_lazyconfig_train_net", "tools/lazyconfig_train_net.py")
    monkeypatch.setattr(sys, "argv", ["lazyconfig_train_net.py", "--config-file", str(cfg)])
    with pytest.raises(SystemExit) as want:
        jax_tool.main()
    with pytest.raises(SystemExit) as got:
        lazyconfig_train_net.main(["--config-file", str(cfg)])
    assert str(got.value) == str(want.value) and "train.entry" in str(got.value)
    assert (tmp_path / "out" / "config.yaml").exists()


def test_lazyconfig_train_net_trains_through_the_example_entry(tmp_path):
    example = os.path.join(REPO, "vnext_tpu_torch", "config", "examples", "idol_lazy.py")
    state, history = lazyconfig_train_net.main([
        "--config-file", example, "model.hidden_dim=64", "model.num_classes=3", "model.num_queries=24",
        "model.nheads=4", "model.dim_feedforward=128", "model.enc_layers=1", "model.dec_layers=2",
        "model.backbone_depth=18", "model.max_insts=8", "train.max_iter=2", f"train.output_dir={tmp_path}",
        f"train.entry.config_file={QUICK}", "train.entry.opts=['MODEL.DEVICE', 'cpu']"])
    assert state.step == len(history) == 2 and all(np.isfinite(h["total_loss"]) for h in history)
    assert (tmp_path / "model_0000002.pth").exists() and (tmp_path / "config.yaml").exists()


@pytest.mark.parametrize("tool", ["demo", "export_model", "analyze_model", "plain_train_net",
                                  "lazyconfig_train_net"])
def test_tools_refuse_the_card_without_one(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    run = {
        "demo": lambda: demo.main(["--config-file", QUICK, "--input", str(tmp_path), "--output", str(tmp_path)]),
        "export_model": lambda: export_model.main(["--config-file", QUICK, "--output", str(tmp_path / "m.pt2")]),
        "analyze_model": lambda: analyze_model.main(["--config-file", QUICK]),
        "plain_train_net": lambda: plain_train_net.main(["--config-file", QUICK, "OUTPUT_DIR", str(tmp_path)]),
        "lazyconfig_train_net": lambda: lazyconfig_train_net.main([
            "--config-file", os.path.join(REPO, "vnext_tpu_torch", "config", "examples", "idol_lazy.py"),
            "model.backbone_depth=18", "model.hidden_dim=64", "model.nheads=4", f"train.output_dir={tmp_path}",
            f"train.entry.config_file={QUICK}"]),
    }[tool]
    Image.fromarray(_frames(2)[0]).save(tmp_path / "000.png")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run()
