"""Mask R-CNN serving end to end in the port against the JAX package, on the
CPU in f32 with the quick-schedule config
(``configs/quick_schedules/mask_rcnn_R_18_instant_test.yaml``: ResNet-18,
FPN 256, 3 classes, 64 proposals, 16 detections, 128x224 padded inputs) and
the synthetic COCO set (8 images at 160x224, 3 classes, polygon masks).

The JAX package's ``engine/detection.do_eval_detection`` runs once, in a
module fixture, on a random flax tree (``random_params``: no init compiled;
one jit of the forward) with its evaluator's ``process`` recorded, so every
case shares one JAX compile:

- ``DetectionDatasetMapper``: both paths, arrays bit-equal to JAX's mapper for
  the same ``random.Random`` seed (masks, and keypoints on a record given some);
- ``COCOEvaluator``: the same bbox and segm AP dicts as JAX's on the same
  per-image outputs (JAX's own, and outputs made from the ground truth with
  jitter, so that AP is neither 0 nor 1), and the same results json;
- ``DetectionInference``, as the entry point calls it: per-image outputs
  equal to the ones JAX's runner gave the evaluator: kept slots and classes exact, boxes and scores at 2e-4 of their
  largest (the f32 convolutions' sums in other orders, as
  tests/test_torch_resnet_basic.py holds the trunk), pasted masks equal;
- the entry point, ``vnext_tpu_torch.tools.train_net.main --eval-only
  MODEL.DEVICE cpu`` with the same tree in ``MODEL.WEIGHTS``: its results dict
  equal to JAX's ``do_eval_detection``'s, and ``TEST.EXPECTED_RESULTS`` verified;
- refusals: an unknown architecture; and what is ported since: the rotated
  evaluator type (tests/test_torch_rotated.py), one Mask R-CNN train step through the entry
  point, PanopticFPN, SemanticSegmentor, ProposalNetwork, RetinaNet, FCOS,
  Cascade and keypoint R-CNN built and taken by the runner, the keypoints task
  evaluated (tests/test_torch_panoptic.py, tests/test_torch_rcnn_heads.py
  hold them against JAX).
"""

import copy
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.config import add_idol_config as jax_add_idol_config
from vnext_tpu.config import get_cfg as jax_get_cfg
from vnext_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from vnext_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from vnext_tpu.data.datasets.synthetic import register_synthetic_coco as jax_register_synthetic_coco
from vnext_tpu.data.detection_mapper import DetectionDatasetMapper as JaxMapper
from vnext_tpu.engine import detection as jax_detection
from vnext_tpu.evaluation.coco_eval import COCOEvaluator as JaxCOCOEvaluator
from vnext_tpu.models import build_model as jax_build_model
from vnext_tpu.ops import mask_ops as jax_mask_ops
from vnext_tpu.models.rcnn import GeneralizedRCNN as JaxRCNN
from vnext_tpu_torch.checkpoint.from_jax import params_from_jax
from vnext_tpu_torch.config import add_idol_config, get_cfg
from vnext_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_coco
from vnext_tpu_torch.data.detection_mapper import DetectionDatasetMapper
from vnext_tpu_torch.engine import detection
from vnext_tpu_torch.ops.mask_ops import paste_masks_in_image
from vnext_tpu_torch.evaluation.coco_eval import COCOEvaluator
from vnext_tpu_torch.evaluation.rle import rle_decode
from vnext_tpu_torch.evaluation.ytvis_eval import build_evaluator
from vnext_tpu_torch.models import build_model
from vnext_tpu_torch.tools import train_net

from _torch_helpers import random_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANT = os.path.join(REPO, "configs", "quick_schedules", "mask_rcnn_R_18_instant_test.yaml")
DATASET = "coco_synthetic_tiny"
OPTS = ["TPU.COMPUTE_DTYPE", "float32"]


def _cfg(get, add, *opts):
    cfg = get()
    add(cfg)
    cfg.merge_from_file(INSTANT)
    cfg.merge_from_list([*OPTS, *opts])
    return cfg


def _close(got, want, scale=2e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * max(1.0, np.abs(want).max()))


def _same_stats(got, want):
    assert set(got) == set(want)
    for task in want:
        assert set(got[task]) == set(want[task]), task
        for k, v in want[task].items():
            assert (np.isnan(v) and np.isnan(got[task][k])) or got[task][k] == pytest.approx(v, abs=1e-12), (task, k)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both catalogs' synthetic COCO set on the same files, one random flax
    tree, and JAX's ``do_eval_detection`` on it with each image's runner output."""
    jax_register_synthetic_coco(root=str(tmp_path_factory.mktemp("synth") / DATASET))
    register_synthetic_coco(root=os.path.dirname(JaxMetadataCatalog.get(DATASET).json_file))
    jcfg = _cfg(jax_get_cfg, jax_add_idol_config, "MODEL.WEIGHTS", "",
                "OUTPUT_DIR", str(tmp_path_factory.mktemp("jax_out")))
    th, tw = jcfg.TPU.TEST_IMAGE_SIZE
    jmodel = jax_build_model(jcfg)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, th, tw, 3)),
                                               jnp.asarray([[th, tw]], jnp.int32), method=JaxRCNN.inference), seed=11)
    seen, pasted = [], []
    process, paste = JaxCOCOEvaluator.process, jax_mask_ops.paste_masks_in_image

    def recording(self, inputs, outputs):
        seen.extend(zip(inputs, outputs))
        return process(self, inputs, outputs)

    def recording_paste(masks, boxes, shape, threshold=0.5):
        pasted.append((np.asarray(masks), np.asarray(boxes), np.asarray(paste(masks, boxes, shape, threshold=-1))))
        return paste(masks, boxes, shape, threshold)

    JaxCOCOEvaluator.process, jax_mask_ops.paste_masks_in_image = recording, recording_paste
    try:
        results = jax_detection.do_eval_detection(jcfg, jax.tree.map(jnp.asarray, params))
    finally:
        JaxCOCOEvaluator.process, jax_mask_ops.paste_masks_in_image = process, paste
    with open(os.path.join(jcfg.OUTPUT_DIR, "coco_instances_results.json")) as f:
        written = json.load(f)
    assert len(pasted) == len(seen) == 8
    return params, results, seen, written, pasted


def _masks_agree(got, want, probs):
    """Thresholded masks equal but where JAX's pasted probability lies within
    5e-4 of 0.5: there an f32 rounding upstream of the threshold decides (the
    mask probabilities agree to 2e-4 of 1, and the boxes they are pasted into
    to 2e-4 of their largest, which moves a pixel's sample by up to ~1e-5 of
    the mask); those pixels are few."""
    differ = got != want
    assert not differ[np.abs(probs - 0.5) > 5e-4].any()
    assert differ.sum() <= 1e-4 * differ.size


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
def test_mapper_matches_jax(served, is_train):
    records = DatasetCatalog.get(DATASET)
    assert len(records) == len(JaxDatasetCatalog.get(DATASET)) == 8
    kw = dict(is_train=is_train, min_sizes=(96, 128, 160) if is_train else (128,), max_size=224,
              max_insts=4, target_size=(160, 224), mask_on=True)
    with_kps = copy.deepcopy(records[0])
    for obj in with_kps["annotations"]:
        x, y, w, h = obj["bbox"]
        kps = np.random.RandomState(int(x)).rand(17, 3) * [w, h, 1] + [x, y, 0]
        kps[:, 2] = np.arange(17) % 3
        obj["keypoints"] = kps.reshape(-1).tolist()
    cases = [(r, False) for r in records] + [(with_kps, True)]
    for seed, (record, kp) in enumerate(cases):
        got = DetectionDatasetMapper(keypoint_on=kp, **kw)(record, random.Random(seed))
        want = JaxMapper(keypoint_on=kp, **kw)(record, random.Random(seed))
        assert sorted(got) == sorted(want)
        assert ("keypoints" in got) == kp
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), (seed, k)
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, (seed, k)
        assert got["valid"].any()


def test_mapper_from_config_matches_jax(served):
    for is_train in (True, False):
        got = DetectionDatasetMapper.from_config(_cfg(get_cfg, add_idol_config), is_train=is_train)
        want = JaxMapper.from_config(_cfg(jax_get_cfg, jax_add_idol_config), is_train=is_train)
        for field in ("is_train", "max_insts", "target_size", "mask_on", "keypoint_on", "num_keypoints"):
            assert getattr(got, field) == getattr(want, field), field
        assert (got.aug.min_sizes, got.aug.max_size, got.aug.flip) == (want.aug.min_sizes, want.aug.max_size,
                                                                       want.aug.flip)


# ---------------------------------------------------------------- evaluator
def _jittered_outputs(records, seed):
    """Per-image outputs from the ground truth: boxes moved a few pixels,
    a wrong class now and then, masks shifted, random scores, a false positive
    and an unused padded slot."""
    rng = np.random.RandomState(seed)
    outputs = []
    for r in records:
        h, w = r["height"], r["width"]
        boxes, classes, masks = [], [], []
        for obj in r["annotations"]:
            x, y, bw, bh = obj["bbox"]
            boxes.append(np.asarray([x, y, x + bw, y + bh]) + rng.randn(4) * 3)
            classes.append(obj["category_id"] if rng.rand() > 0.2 else (obj["category_id"] + 1) % 3)
            m = np.zeros((h, w), bool)
            x0, y0 = int(x + rng.randint(-4, 5)), int(y + rng.randint(-4, 5))
            m[max(y0, 0): max(y0 + int(bh), 0), max(x0, 0): max(x0 + int(bw), 0)] = True
            masks.append(m)
        boxes.append([5, 5, 60, 50])
        classes.append(0)
        masks.append(np.zeros((h, w), bool))
        boxes.append([0, 0, 1, 1])
        classes.append(1)
        masks.append(np.ones((h, w), bool))
        n = len(boxes)
        outputs.append({"boxes": np.asarray(boxes, np.float32), "scores": rng.rand(n).astype(np.float32),
                        "classes": np.asarray(classes, np.int64), "valid": np.arange(n) < n - 1,
                        "masks": np.stack(masks)})
    return outputs


def test_coco_evaluator_matches_jax(served, tmp_path):
    """The same AP dicts, bbox and segm, on JAX's runner outputs and on
    jittered ground truth, and the same results json."""
    _, _, seen, _, _ = served
    records = [r for r, _ in seen]
    for name, outputs in (("runner", [o for _, o in seen]), ("jittered", _jittered_outputs(records, 0))):
        got_ev = COCOEvaluator(DATASET, ("bbox", "segm"), str(tmp_path / name / "port"))
        want_ev = JaxCOCOEvaluator(DATASET, ("bbox", "segm"), str(tmp_path / name / "jax"))
        for ev in (got_ev, want_ev):
            ev.reset()
            for r, o in zip(records, outputs):
                ev.process([r], [o])
        got, want = got_ev.evaluate(), want_ev.evaluate()
        _same_stats(got, want)
        with open(tmp_path / name / "port" / "coco_instances_results.json") as f, \
                open(tmp_path / name / "jax" / "coco_instances_results.json") as g:
            assert json.load(f) == json.load(g), name
        if name == "jittered":
            assert 0.05 < got["bbox"]["AP"] < 0.95 and 0.05 < got["segm"]["AP"] < 0.95, got
    assert COCOEvaluator("no_such_set_json", ("bbox",)).evaluate() == {}


def test_build_evaluator_coco_and_keypoints_refusal(served, tmp_path):
    """The COCO evaluator's tasks from the config: bbox, segm with
    ``MODEL.MASK_ON``, keypoints with ``MODEL.KEYPOINT_ON`` (which the port
    refused before keypoint R-CNN was ported), as JAX's ``build_evaluator``."""
    cfg = _cfg(get_cfg, add_idol_config, "OUTPUT_DIR", str(tmp_path))
    ev = build_evaluator(cfg, DATASET)
    assert isinstance(ev, COCOEvaluator) and ev._tasks == ("bbox", "segm")
    cfg.MODEL.MASK_ON = False
    assert build_evaluator(cfg, DATASET)._tasks == ("bbox",)
    cfg.MODEL.KEYPOINT_ON = True
    assert build_evaluator(cfg, DATASET)._tasks == ("bbox", "keypoints")


# ---------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def port_served(served, tmp_path_factory):
    """``train_net.main --eval-only MODEL.DEVICE cpu`` with the tree in
    ``MODEL.WEIGHTS`` (a port checkpoint), each image's runner output recorded:
    (the results, [(record, output)], the output directory)."""
    params = served[0]
    tmp = tmp_path_factory.mktemp("port_served")
    weights = str(tmp / "rcnn.pth")
    torch.save({"model": params_from_jax(params)}, weights)
    seen, call = [], detection.DetectionInference.__call__

    def recording(self, record):
        seen.append((record, call(self, record)))
        return seen[-1][1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(detection.DetectionInference, "__call__", recording)
        results = train_net.main(["--config-file", INSTANT, "--eval-only", *OPTS, "MODEL.DEVICE", "cpu",
                                  "MODEL.WEIGHTS", weights, "OUTPUT_DIR", str(tmp / "out")])
    return results, seen, tmp / "out"


def test_detection_inference_matches_jax(served, port_served):
    """The port's runner on each image, as the entry point calls it, against
    what JAX's runner gave its evaluator. The pasted masks: the port's paste on
    JAX's own mask probabilities and boxes gives JAX's masks exactly; the
    runner's own masks as ``_masks_agree`` says."""
    _, _, seen, _, pasted = served
    _, port_seen, _ = port_served
    assert [r["image_id"] for r, _ in port_seen] == [r["image_id"] for r, _ in seen]
    kept = 0
    for (record, want), (_, got), (jax_probs, jax_boxes, jax_pasted) in zip(seen, port_seen, pasted):
        assert sorted(got) == sorted(want) == ["boxes", "classes", "masks", "scores", "valid"]
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_array_equal(got["classes"], want["classes"])
        _close(got["scores"], want["scores"])
        _close(got["boxes"], want["boxes"])
        assert got["masks"].shape == want["masks"].shape == (16, record["height"], record["width"])
        on_jax = paste_masks_in_image(torch.from_numpy(jax_probs), torch.from_numpy(jax_boxes), want["masks"].shape[1:])
        np.testing.assert_array_equal(on_jax.numpy(), want["masks"])
        _masks_agree(got["masks"], want["masks"], jax_pasted)
        kept += int(want["valid"].sum())
    assert kept > 0, "the random weights must give detections"


def test_resize_nearest_matches_jax():
    arr = np.arange(7 * 9).reshape(7, 9)
    for shape in ((14, 18), (5, 4), (7, 9), (23, 31)):
        np.testing.assert_array_equal(detection._resize_nearest(arr, shape), jax_detection._resize_nearest(arr, shape))


def test_entry_point_equals_jax(served, port_served):
    """The entry point's results equal JAX's ``do_eval_detection``'s, its
    results json JAX's (masks as ``_masks_agree`` says), and the quick
    schedule's ``TEST.EXPECTED_RESULTS`` (AP 0 +- 0.02, bbox and segm) held."""
    _, want, seen, written, pasted = served
    got, _, out = port_served
    assert list(got) == list(want) == [DATASET]
    _same_stats(got[DATASET], want[DATASET])
    assert sorted(got[DATASET]) == ["bbox", "segm"]
    with open(out / "coco_instances_results.json") as f:
        entries = json.load(f)
    assert len(entries) == len(written) > 0
    # each entry is a kept detection, image by image in the loader's order
    probs = [p for (_, o), (_, _, image_probs) in zip(seen, pasted) for p in image_probs[o["valid"]]]
    assert len(probs) == len(entries)
    for a, b, p in zip(entries, written, probs):
        assert (a["image_id"], a["category_id"]) == (b["image_id"], b["category_id"])
        _masks_agree(rle_decode(a["segmentation"]), rle_decode(b["segmentation"]), p)
        np.testing.assert_allclose(a["score"], b["score"], rtol=0, atol=2e-4)
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=2e-4 * 224)
    assert rle_decode(entries[0]["segmentation"]).shape == (160, 224)


# ---------------------------------------------------------------- refusals
def test_refusals_name_their_item(served, tmp_path):
    out = ["MODEL.DEVICE", "cpu", "OUTPUT_DIR", str(tmp_path)]
    # training Mask R-CNN is ported (tests/test_torch_rcnn_train.py): one step through the entry point (a
    # narrow FPN: the box head's first layer, the cost of building and saving the model, shrinks with it)
    trainer = train_net.main(["--config-file", INSTANT, *out, "SOLVER.MAX_ITER", "1", "DATASETS.TEST", "()",
                              "MODEL.FPN.OUT_CHANNELS", "32"])
    assert trainer.iter == 1 and np.isfinite(trainer.storage.history("loss_mask").values()).all()
    # FCOS is ported (tests/test_torch_dense_detectors.py and tests/test_torch_rcnn_heads.py hold it): its
    # quick schedule serves through the entry point, scored by the COCO evaluator's bbox AP
    fcos = os.path.join(REPO, "configs", "quick_schedules", "fcos_R_18_instant_test.yaml")
    served_fcos = train_net.main(["--config-file", fcos, "--eval-only", *out])
    assert sorted(served_fcos[DATASET]) == ["bbox"]
    cfg = _cfg(get_cfg, add_idol_config)
    # PanopticFPN and SemanticSegmentor are ported since (tests/test_torch_panoptic.py holds them against JAX), and
    # so are ProposalNetwork, RetinaNet and FCOS: each builds, and the runner takes it
    for arch in ("PanopticFPN", "SemanticSegmentor", "ProposalNetwork", "RetinaNet", "FCOS"):
        cfg.MODEL.META_ARCHITECTURE = arch
        assert type(build_model(cfg, device="meta")).__name__ == arch
        assert detection.DetectionInference(cfg, torch.nn.Linear(1, 1)).arch == arch
    cfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    # keypoint R-CNN and Cascade R-CNN are ported: their heads are built; the cascade is box-only, as JAX's
    for key, value, head in (("MODEL.KEYPOINT_ON", "True", "keypoint_head"), ("MODEL.ROI_HEADS.NAME",
                                                                               "CascadeROIHeads", "stage2")):
        other = cfg.clone()
        other.merge_from_list([key, value, "MODEL.MASK_ON", "False"])
        assert hasattr(build_model(other, device="meta").roi_heads, head)
        other.merge_from_list(["MODEL.MASK_ON", "True"])
        if head == "stage2":
            with pytest.raises(ValueError, match="box-only"):
                build_model(other, device="meta")
    assert type(build_model(cfg, device="meta")).__name__ == "GeneralizedRCNN"
    assert COCOEvaluator(DATASET, ("bbox", "keypoints"))._tasks == ("bbox", "keypoints")
    # LVIS is the LVIS evaluator since its datasets are ported (tests/test_torch_datasets_extra.py), and the
    # rotated type the rotated evaluator since the rotated boxes are (tests/test_torch_rotated.py)
    MetadataCatalog.get("detection_lvis_kind").set(evaluator_type="lvis")
    assert type(build_evaluator(cfg, "detection_lvis_kind")).__name__ == "LVISEvaluator"
    MetadataCatalog.get("detection_rotated_kind").set(evaluator_type="rotated_coco")
    assert type(build_evaluator(cfg, "detection_rotated_kind")).__name__ == "RotatedCOCOEvaluator"
    cfg.MODEL.META_ARCHITECTURE = "NoSuchArch"
    with pytest.raises(KeyError, match="No object named"):
        build_model(cfg, device="meta")
