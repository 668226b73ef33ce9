"""The port's video-AP evaluator against the JAX package's, on the CPU.

RLE encode / decode / area / IoU, the tube-IoU ``YTVOSeval`` (through the
native C library and through the Python path, which must give the same
stats), ``YTVISEvaluator`` (``results.json`` entry for entry and the stats
dict) and the result checks of ``evaluation/testing.py``, each against the
JAX package's on the same inputs. The ground truth is the synthetic YTVIS
dataset; the predictions are crafted from it: the ground truth shuffled, masks
perturbed, frames missing, categories swapped, false positives added.
"""

import json
import math
import os

import numpy as np
import pytest

from vnext_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from vnext_tpu.data.datasets import synthetic as jax_synthetic
from vnext_tpu.data.datasets.ytvis import register_ytvis_instances as jax_register
from vnext_tpu.evaluation import rle as jax_rle
from vnext_tpu.evaluation import testing as jax_testing
from vnext_tpu.evaluation.evaluator import DatasetEvaluators as JaxDatasetEvaluators
from vnext_tpu.evaluation.evaluator import inference_on_dataset as jax_inference_on_dataset
from vnext_tpu.evaluation.ytvis_eval import YTVISEvaluator as JaxYTVISEvaluator
from vnext_tpu.evaluation.ytvis_eval import _normalize_gt as jax_normalize_gt
from vnext_tpu.evaluation.ytvos_eval import YTVOSeval as JaxYTVOSeval
from vnext_tpu.evaluation.ytvos_eval import tube_iou as jax_tube_iou
from vnext_tpu_torch.config import get_cfg
from vnext_tpu_torch.data.catalog import MetadataCatalog
from vnext_tpu_torch.data.datasets.ytvis import register_ytvis_instances
from vnext_tpu_torch.evaluation import native, rle, testing
from vnext_tpu_torch.evaluation.evaluator import DatasetEvaluators, inference_on_dataset
from vnext_tpu_torch.evaluation.ytvis_eval import YTVISEvaluator, _normalize_gt, build_evaluator
from vnext_tpu_torch.evaluation.ytvos_eval import YTVOSeval, _match_greedy, tube_iou
from vnext_tpu_torch.utils.events import EventStorage


def _same(a, b):
    """Stats dicts equal, NaN equal to NaN (a bin with no ground truth)."""
    assert set(a) == set(b)
    for k in a:
        assert (math.isnan(a[k]) and math.isnan(b[k])) or a[k] == b[k], (k, a[k], b[k])


@pytest.fixture(scope="module")
def gt_json(tmp_path_factory):
    """The synthetic dataset's json (5 videos of 6 frames at 96x144)."""
    root = str(tmp_path_factory.mktemp("gt"))
    return jax_synthetic.generate_synthetic_ytvis(root, num_videos=5, num_frames=6, h=96, w=144, seed=4)


def _gt(path):
    with open(path) as f:
        return jax_normalize_gt(json.load(f))


def _crafted_predictions(gt, seed):
    """Predictions from the ground truth: shuffled, masks dilated or cut, some
    frames missing, some categories wrong, some tubes moved, extra noise tubes."""
    rng = np.random.RandomState(seed)
    anns = list(gt["annotations"])
    rng.shuffle(anns)
    preds = []
    for a in anns:
        segms = []
        for s in a["segmentations"]:
            m = jax_rle.rle_decode(s)
            kind = rng.randint(4)
            if kind == 1:
                m = np.roll(m, rng.randint(-6, 7), axis=1)
            elif kind == 2:
                m = m & (rng.rand(*m.shape) > 0.3)
            segms.append(None if kind == 3 else jax_rle.rle_encode(m))
        cat = a["category_id"] if rng.rand() > 0.2 else 1 + (a["category_id"] % 3)
        preds.append({"video_id": a["video_id"], "category_id": cat, "score": float(rng.rand()),
                      "segmentations": segms})
    h, w = gt["videos"][0]["height"], gt["videos"][0]["width"]
    for v in gt["videos"]:
        for _ in range(2):
            m = np.zeros((h, w), bool)
            y, x = rng.randint(0, h - 20), rng.randint(0, w - 20)
            m[y:y + 20, x:x + 20] = True
            preds.append({"video_id": v["id"], "category_id": int(rng.randint(1, 4)), "score": float(rng.rand()),
                          "segmentations": [jax_rle.rle_encode(m)] * v["length"]})
    return preds


# ---------------------------------------------------------------- RLE
@pytest.mark.parametrize("kind", ["random", "empty", "full", "first_pixel_set"])
def test_rle_codec_area_iou_equal_jax(kind):
    rng = np.random.RandomState(0)
    h, w = 37, 53
    masks = {"random": rng.rand(h, w) > 0.5, "empty": np.zeros((h, w), bool), "full": np.ones((h, w), bool),
             "first_pixel_set": np.pad(np.ones((5, 5), bool), ((0, h - 5), (0, w - 5)))}
    m = masks[kind]
    other = rng.rand(h, w) > 0.7
    enc = rle.rle_encode(m)
    assert enc == jax_rle.rle_encode(m)
    assert np.array_equal(rle.rle_decode(enc), m) and np.array_equal(rle.rle_decode(enc), jax_rle.rle_decode(enc))
    raw = {"size": [h, w], "counts": rle.mask_to_counts(m)}               # uncompressed counts decode too
    assert np.array_equal(rle.rle_decode(raw), m)
    assert rle.decompress_counts(enc["counts"].encode()) == jax_rle.decompress_counts(enc["counts"])
    assert rle.rle_area(enc) == jax_rle.rle_area(enc) == int(m.sum())
    assert rle.rle_iou(enc, rle.rle_encode(other)) == jax_rle.rle_iou(enc, jax_rle.rle_encode(other))


def test_tube_iou_equals_jax():
    rng = np.random.RandomState(1)
    frames = [rng.rand(20, 30) > 0.5 for _ in range(4)]
    det = [rle.rle_encode(f) for f in frames[:3]] + [None]
    gt = [None] + [rle.rle_encode(np.roll(f, 2, axis=0)) for f in frames[1:]]
    for crowd in (False, True):
        assert tube_iou(det, gt, iscrowd=crowd) == jax_tube_iou(det, gt, iscrowd=crowd)
    assert tube_iou([None], [None]) == 0.0


# ---------------------------------------------------------------- YTVOSeval
@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ytvoseval_stats_equal_jax(gt_json, monkeypatch, path, seed):
    if path == "native":
        assert native.available(), "the native library should build where a C compiler is"
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    preds = _crafted_predictions(_gt(gt_json), seed)
    want = JaxYTVOSeval(_gt(gt_json), preds).evaluate()
    got = YTVOSeval(_gt(gt_json), preds).evaluate()
    _same(got, want)
    assert 0.0 < got["AP"] < 1.0


def test_native_and_python_matching_agree(monkeypatch):
    rng = np.random.RandomState(3)
    iou = np.sort(rng.rand(9, 6), axis=0)[::-1]
    ignore = np.array([0, 0, 0, 0, 1, 1], bool)
    crowd = np.array([0, 0, 0, 0, 0, 1], bool)
    thrs = np.linspace(0.5, 0.95, 10)
    native_out = _match_greedy(iou, ignore, thrs, crowd)
    monkeypatch.setattr(native, "available", lambda: False)
    python_out = _match_greedy(iou, ignore, thrs, crowd)
    assert all(np.array_equal(a, b) for a, b in zip(native_out, python_out))
    assert native_out[0].any() and native_out[1].any()
    assert _match_greedy(iou, ignore, thrs)[0].shape == (10, 9)


def test_ground_truth_as_predictions_scores_ap_one(gt_json):
    """A perfect submission: AP 1.0 (the evaluators report fractions) in both
    packages; the area bins holding no ground truth read NaN."""
    gt = _gt(gt_json)
    preds = [{"video_id": a["video_id"], "category_id": a["category_id"], "score": 1.0,
              "segmentations": a["segmentations"]} for a in gt["annotations"]]
    got, want = YTVOSeval(_gt(gt_json), preds).evaluate(), JaxYTVOSeval(_gt(gt_json), preds).evaluate()
    _same(got, want)
    assert got["AP"] == got["AP50"] == got["AR@100"] == 1.0


# ---------------------------------------------------------------- YTVISEvaluator
def _video_outputs(gt, seed):
    """Runner-style outputs per video record, from the ground truth's masks."""
    rng = np.random.RandomState(seed)
    h, w = gt["videos"][0]["height"], gt["videos"][0]["width"]
    outputs = {}
    for v in gt["videos"]:
        scores, labels, masks = [], [], []
        for a in (a for a in gt["annotations"] if a["video_id"] == v["id"]):
            scores.append(float(rng.rand()))
            labels.append(int(a["category_id"]) - 1)
            masks.append([None if rng.rand() < 0.2 else np.roll(jax_rle.rle_decode(s), rng.randint(-3, 4), 0)
                          for s in a["segmentations"]])
        outputs[v["id"]] = {"image_size": (h, w), "pred_scores": scores, "pred_labels": labels, "pred_masks": masks}
    return outputs


def test_ytvis_evaluator_equals_jax(gt_json, tmp_path):
    name = "eval_synthetic_port_and_jax"
    image_root = os.path.join(os.path.dirname(gt_json), "JPEGImages")
    register_ytvis_instances(name, {"thing_classes": ["square", "wide", "tall"]}, gt_json, image_root)
    jax_register(name, {"thing_classes": ["square", "wide", "tall"]}, gt_json, image_root)
    with open(gt_json) as f:
        videos = json.load(f)["videos"]
    records = [{"video_id": v["id"], "height": v["height"], "width": v["width"]} for v in videos]
    outputs = _video_outputs(_gt(gt_json), seed=5)
    results = {}
    for tag, cls in (("port", YTVISEvaluator), ("jax", JaxYTVISEvaluator)):
        ev = cls(name, output_dir=str(tmp_path / tag))
        ev.reset()
        for r in records:
            ev.process([r], [outputs[r["video_id"]]])
        results[tag] = ev.evaluate()
    assert set(results["port"]) == {"segm"}
    _same(results["port"]["segm"], results["jax"]["segm"])
    with open(tmp_path / "port" / "results.json") as f, open(tmp_path / "jax" / "results.json") as g:
        got, want = json.load(f), json.load(g)
    assert len(got) == sum(len(o["pred_scores"]) for o in outputs.values()) and got == want
    assert MetadataCatalog.get(name).evaluator_type == JaxMetadataCatalog.get(name).evaluator_type == "ytvis"


def test_evaluator_without_ground_truth_writes_results_only(tmp_path):
    name = "eval_test_split_port"
    split = tmp_path / "test.json"
    split.write_text(json.dumps({"videos": [{"id": 1, "height": 4, "width": 6, "length": 1,
                                             "file_names": ["a.png"]}], "categories": []}))
    register_ytvis_instances(name, {}, str(split), str(tmp_path))
    ev = YTVISEvaluator(name, output_dir=str(tmp_path / "out"))
    ev.process([{"video_id": 1, "height": 4, "width": 6}],
               [{"image_size": (4, 6), "pred_scores": [0.5], "pred_labels": [2],
                 "pred_masks": [[np.ones((4, 6), bool)]]}])
    assert ev.evaluate() == {}
    entries = json.loads((tmp_path / "out" / "results.json").read_text())
    assert entries[0]["category_id"] == 3 and entries[0]["segmentations"][0]["size"] == [4, 6]


def test_normalize_gt_equals_jax(gt_json):
    with open(gt_json) as f:
        raw = json.load(f)
    raw["annotations"][0]["segmentations"][1] = None
    a, b = json.loads(json.dumps(raw)), json.loads(json.dumps(raw))
    assert _normalize_gt(a) == jax_normalize_gt(b)


def test_build_evaluator_has_the_ytvis_type_only(tmp_path):
    cfg = get_cfg()
    cfg.OUTPUT_DIR = str(tmp_path)
    MetadataCatalog.get("eval_ytvis_kind").set(evaluator_type="ytvis")
    assert isinstance(build_evaluator(cfg, "eval_ytvis_kind"), YTVISEvaluator)
    # the COCO type is the COCO evaluator since Mask R-CNN serves (tests/test_torch_detection.py)
    MetadataCatalog.get("eval_coco_kind").set(evaluator_type="coco")
    assert type(build_evaluator(cfg, "eval_coco_kind")).__name__ == "COCOEvaluator"
    # the panoptic and semantic types since PanopticFPN and SemanticSegmentor serve (tests/test_torch_panoptic.py)
    MetadataCatalog.get("eval_panoptic_kind").set(evaluator_type="coco_panoptic_seg")
    assert [type(e).__name__ for e in build_evaluator(cfg, "eval_panoptic_kind")._evaluators] == [
        "COCOEvaluator", "COCOPanopticEvaluator"]
    MetadataCatalog.get("eval_sem_seg_kind").set(evaluator_type="sem_seg")
    assert type(build_evaluator(cfg, "eval_sem_seg_kind")).__name__ == "SemSegEvaluator"
    # LVIS, VOC and Cityscapes since their datasets are ported (tests/test_torch_datasets_extra.py), the rotated
    # type since the rotated boxes are (tests/test_torch_rotated.py)
    MetadataCatalog.get("eval_lvis_kind").set(evaluator_type="lvis")
    assert type(build_evaluator(cfg, "eval_lvis_kind")).__name__ == "LVISEvaluator"
    MetadataCatalog.get("eval_rotated_kind").set(evaluator_type="rotated_coco")
    assert type(build_evaluator(cfg, "eval_rotated_kind")).__name__ == "RotatedCOCOEvaluator"


def test_inference_loop_and_combiner_equal_jax():
    class Collect:
        def __init__(self, key):
            self.key, self.seen = key, []

        def reset(self):
            self.seen = []

        def process(self, inputs, outputs):
            self.seen += [(i, o) for i, o in zip(inputs, outputs)]

        def evaluate(self):
            return {self.key: {"n": len(self.seen), "sum": sum(o for _, o in self.seen)}}

    data = list(range(8))
    got = inference_on_dataset(lambda x: x * 2, data, DatasetEvaluators([Collect("a"), Collect("b")]), warmup_iters=2)
    want = jax_inference_on_dataset(lambda x: x * 2, data, JaxDatasetEvaluators([Collect("a"), Collect("b")]),
                                    warmup_iters=2)
    assert dict(got) == dict(want) == {"a": {"n": 8, "sum": 56}, "b": {"n": 8, "sum": 56}}
    with pytest.raises(ValueError, match="'a'"):
        DatasetEvaluators([Collect("a"), Collect("a")]).evaluate()
    assert inference_on_dataset(lambda x: x, [], None) == {}


# ---------------------------------------------------------------- testing.py
def test_result_checks_equal_jax():
    cfg = get_cfg()
    cfg.TEST.EXPECTED_RESULTS = [["segm", "AP", 0.5, 0.01]]
    results = {"segm": {"AP": 0.505, "AP50": 0.9}}
    assert testing.verify_results(cfg, results) and jax_testing.verify_results(cfg, results)
    for bad in ({"segm": {"AP": 0.6}}, {"segm": {"AP": float("nan")}}, {}):
        for mod in (testing, jax_testing):
            with pytest.raises(AssertionError, match="Result verification failed"):
                mod.verify_results(cfg, bad)
    nested = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    assert testing.flatten_results_dict(nested) == jax_testing.flatten_results_dict(nested) == \
        {"a/b": 1, "a/c/d": 2, "e": 3}


@pytest.mark.parametrize("losses, ok", [([3.0, 2.0, 1.5], True), ([3.0, 9.0, 8.0], False),
                                        ([1.0, 1.0, float("nan")], False)])
def test_verify_final_loss_equals_jax(losses, ok):
    cfg = get_cfg()
    cfg.TEST.FINAL_LOSS_BOUND = 5.0

    class Trainer:
        pass

    trainer = Trainer()
    with EventStorage() as trainer.storage:
        for v in losses:
            trainer.storage.put_scalar("total_loss", v)
    for mod in (testing, jax_testing):
        if ok:
            assert mod.verify_final_loss(cfg, trainer)
        else:
            with pytest.raises(AssertionError):
                mod.verify_final_loss(cfg, trainer)
    trainer.storage = EventStorage()
    with pytest.raises(AssertionError, match="no total_loss"):
        testing.verify_final_loss(cfg, trainer)
