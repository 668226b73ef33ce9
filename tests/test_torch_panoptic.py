"""PanopticFPN and SemanticSegmentor in the port against the JAX package, on
the CPU in f32, with their evaluators, the COCO-panoptic loader, the mapper's
semantic ground truth and the entry point.

Each model is tiny (ResNet-18, FPN 32 channels; PanopticFPN: 4 thing
classes, 5 semantic classes, 32 proposals after NMS, an ROI batch of 16 at
0.25 positive, 8 detections; two images at 64x96 with true sizes 64x85 and
56x96, 6 ground-truth slots of which 3 and 2 hold objects, labels at 16x24
with ignored pixels), built once from a random flax tree (``random_params``)
with the RPN's ``anchor_deltas`` kernel scaled by 0.01, as
tests/test_torch_rcnn_train.py builds Mask R-CNN, and bridged by
``load_from_jax`` (no key left over either way). One jitted JAX function per
model returns its FPN maps, the semantic head's logits, the losses and the
inference. The port draws its sampling priorities from
``rcnn.sampling_priorities``, replaced by JAX's ``jax.random.uniform`` arrays
(the RPN's from the step's key, the ROIs' from ``fold_in(key, 7)``).

Tolerances (f32 on both sides, the convolutions' sums in other orders): the
semantic head on JAX's own FPN maps at rtol 1e-4 / atol 1e-5; the whole
models' logits at rtol 1e-4 / atol 1e-5 of their largest, their losses at
1e-4 relative; the argmax equal wherever the two best logits are 1e-4 of
the largest apart; the detections' kept slots and classes exactly, boxes and
scores at 2e-4 of their largest (as tests/test_torch_rcnn.py holds Mask
R-CNN). The fusion, the evaluators' dicts, the id encoding, the loader's
records and the mapper's batches are equal exactly.

The two faults of the JAX package that the port repairs (ROADMAP Queue 3,
item 6) each have their test: JAX's mapper never writes the semantic ground
truth (so JAX's adapter raises ``KeyError`` for SemanticSegmentor), and JAX's
runner makes no ``panoptic_seg`` while its evaluators read arrays no loader
gives (``KeyError`` again); wherever JAX's code runs, the port's equals it.
"""

import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vnext_tpu.config import add_idol_config as jax_add_idol_config
from vnext_tpu.config import get_cfg as jax_get_cfg
from vnext_tpu.data.augmentation import AugInput as JaxAugInput
from vnext_tpu.data.datasets import coco_panoptic as jax_coco_panoptic
from vnext_tpu.data.detection_mapper import DetectionDatasetMapper as JaxMapper
from vnext_tpu.data.detection_mapper import stack_detection_batch as jax_stack_detection_batch
from vnext_tpu.engine import detection as jax_detection
from vnext_tpu.evaluation.panoptic_eval import COCOPanopticEvaluator as JaxPanopticEvaluator
from vnext_tpu.evaluation.panoptic_eval import pq_single_image as jax_pq_single_image
from vnext_tpu.evaluation.sem_seg_eval import SemSegEvaluator as JaxSemSegEvaluator
from vnext_tpu.models.rcnn import PanopticFPN as JaxPanopticFPN
from vnext_tpu.models.retinanet import DetTargets as JaxDetTargets
from vnext_tpu.models.semantic_seg import SemanticSegmentor as JaxSemanticSegmentor
from vnext_tpu.models.semantic_seg import combine_semantic_and_instance_outputs as jax_combine
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.config import add_idol_config, get_cfg
from vnext_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from vnext_tpu_torch.data.datasets import coco_panoptic
from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_panoptic
from vnext_tpu_torch.data.detection_mapper import DetectionDatasetMapper, stack_detection_batch
from vnext_tpu_torch.engine import detection
from vnext_tpu_torch.evaluation.evaluator import DatasetEvaluators
from vnext_tpu_torch.evaluation.panoptic_eval import COCOPanopticEvaluator, pq_single_image
from vnext_tpu_torch.evaluation.sem_seg_eval import SemSegEvaluator
from vnext_tpu_torch.evaluation.ytvis_eval import build_evaluator
from vnext_tpu_torch.models import build_model, rcnn
from vnext_tpu_torch.models.rcnn import DetTargets, PanopticFPN
from vnext_tpu_torch.models.semantic_seg import SemanticSegmentor, combine_semantic_and_instance_outputs
from vnext_tpu_torch.tools import train_net

from _torch_helpers import random_params, t

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PANOPTIC_YAML = os.path.join(REPO, "configs", "COCO-PanopticSegmentation", "panoptic_fpn_R_50_1x.yaml")
H, W, K, SEM = 64, 96, 6, 5
SIZES = np.asarray([[64, 85], [56, 96]], np.int32)
TINY = dict(num_classes=4, backbone_depth=18, fpn_channels=32, proposals_per_image=32, roi_batch_per_image=16,
            roi_pos_fraction=0.25, max_detections=8, mask_on=True)
PAN = dict(TINY, sem_seg_classes=SEM)
SEMSEG = dict(num_classes=SEM, backbone_depth=18, fpn_channels=32)
TOL = 1e-4


def _close(got, want, rtol=TOL, atol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(np.abs(want).max(), 1.0))


def _inputs(seed):
    """Images, targets (3 and 2 objects, each with an ellipse mask) and
    semantic labels at H/4 (a tenth of them ignored)."""
    rng = np.random.RandomState(seed)
    images = rng.randn(2, H, W, 3).astype(np.float32)
    boxes = np.zeros((2, K, 4), np.float32)
    boxes[..., 2:] = 1e-4
    labels = np.zeros((2, K), np.int32)
    valid = np.zeros((2, K), bool)
    masks = np.zeros((2, K, H, W), bool)
    yy, xx = np.mgrid[:H, :W] + 0.5
    for b, n in enumerate((3, 2)):
        for k in range(n):
            x1, y1 = rng.uniform(0, SIZES[b, 1] - 30), rng.uniform(0, SIZES[b, 0] - 24)
            x2, y2 = x1 + rng.uniform(16, 30), y1 + rng.uniform(12, 24)
            boxes[b, k] = x1, y1, x2, y2
            labels[b, k] = rng.randint(0, TINY["num_classes"])
            valid[b, k] = True
            cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
            masks[b, k] = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
    sem = rng.randint(0, SEM, (2, H // 4, W // 4)).astype(np.int32)
    sem[rng.rand(*sem.shape) < 0.1] = 255
    return images, labels, boxes, valid, masks, sem


class Priorities:
    """``rcnn.sampling_priorities`` replaced: the given arrays in turn."""

    def __init__(self, arrays):
        self.arrays, self.i = arrays, 0

    def __call__(self, shape, generator, device):
        out = torch.from_numpy(self.arrays[self.i % len(self.arrays)])
        assert tuple(out.shape) == tuple(shape), (tuple(out.shape), tuple(shape))
        self.i += 1
        return out.to(device)


def _nchw(x):
    return t(np.asarray(x)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def panoptic():
    images, labels, boxes, valid, masks, sem = _inputs(1)
    jmodel = JaxPanopticFPN(**PAN)
    jt = JaxDetTargets(labels=jnp.asarray(labels), boxes=jnp.asarray(boxes), valid=jnp.asarray(valid))
    key = jax.random.PRNGKey(3)
    args = (jnp.asarray(images), jnp.asarray(SIZES), jt)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), *args, sem_seg_gt=jnp.asarray(sem), train=True,
                                               rng_key=key, gt_masks=jnp.asarray(masks, jnp.float32)), seed=5)
    rpn = params["rpn"]
    params = {**params, "rpn": {**rpn, "anchor_deltas": {**rpn["anchor_deltas"],
                                                         "kernel": rpn["anchor_deltas"]["kernel"] * 0.01}}}

    def head(m, images):
        feats = m._features(images)
        return feats, m.sem_seg_head(feats)

    def run(p, images, sizes, targets, sem, gt_masks):
        losses = jmodel.apply({"params": p}, images, sizes, targets, sem_seg_gt=sem, train=True, rng_key=key,
                              gt_masks=gt_masks)
        out = jmodel.apply({"params": p}, images, sizes, method=JaxPanopticFPN.inference)
        return losses, out, jmodel.apply({"params": p}, images, method=head)

    losses, out, (feats, logits) = jax.jit(run)(params, *args, jnp.asarray(sem), jnp.asarray(masks, jnp.float32))
    n_anchors = sum(3 * -(-H // s) * -(-W // s) for s in (4, 8, 16, 32, 64))
    priorities = [np.array(jax.random.uniform(key, (2, n_anchors))),
                  np.array(jax.random.uniform(jax.random.fold_in(key, 7), (2, TINY["proposals_per_image"] + K)))]
    port = PanopticFPN(**PAN).train()
    load_from_jax(port, params)
    targets = DetTargets(*(torch.from_numpy(a) for a in (labels, boxes, valid)))
    got = {}
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        for with_sem in (True, False):
            mp.setattr(rcnn, "sampling_priorities", Priorities(priorities))
            got[with_sem] = port(t(images), torch.from_numpy(SIZES), targets, torch.from_numpy(masks),
                                 torch.from_numpy(sem) if with_sem else None)
        port.eval()
        det = port(t(images), torch.from_numpy(SIZES))
    return dict(want=dict(losses={k: float(v) for k, v in losses.items()}, det=jax.tree.map(np.asarray, out),
                          feats=jax.tree.map(np.asarray, feats), logits=np.asarray(logits)),
                got={k: {n: float(v) for n, v in d.items()} for k, d in got.items()},
                det={k: v.numpy() for k, v in det.items()}, port=port, params=params)


@pytest.fixture(scope="module")
def semseg():
    images, _, _, _, _, sem = _inputs(2)
    jmodel = JaxSemanticSegmentor(**SEMSEG)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(sem)), seed=7)

    def run(p, images, sem):
        return (jmodel.apply({"params": p}, images, sem), jmodel.apply({"params": p}, images, method=jmodel.logits),
                jmodel.apply({"params": p}, images, method=JaxSemanticSegmentor.inference))

    losses, logits, argmax = jax.jit(run)(params, jnp.asarray(images), jnp.asarray(sem))
    port = SemanticSegmentor(**SEMSEG).train()
    load_from_jax(port, params)
    with torch.no_grad():
        got_loss = port(t(images), torch.from_numpy(sem))
        port.eval()
        got_logits, got_argmax = port.logits(t(images)), port(t(images))
    return dict(want=(float(losses["loss_sem_seg"]), np.asarray(logits), np.asarray(argmax)),
                got=(float(got_loss["loss_sem_seg"]), got_logits.permute(0, 2, 3, 1).numpy(), got_argmax.numpy()))


def _argmax_agrees(got, want, logits):
    """Equal wherever the two best logits are more than 1e-4 of the largest apart."""
    top2 = np.sort(logits, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > TOL * np.abs(logits).max()
    assert clear.mean() > 0.9, clear.mean()
    np.testing.assert_array_equal(got[clear], want[clear])


# ---------------------------------------------------------------- the models
def test_sem_seg_head_matches_jax(panoptic):
    """``SemSegFPNHead`` on JAX's own p2-p5: conv, GroupNorm(32), ReLU, bilinear to p2, sum, 1x1."""
    feats = {k: _nchw(v) for k, v in panoptic["want"]["feats"].items()}
    with torch.no_grad():
        got = panoptic["port"].sem_seg_head(feats).permute(0, 2, 3, 1)
    want = panoptic["want"]["logits"]
    assert got.shape == want.shape == (2, H // 4, W // 4, SEM) and got.dtype == torch.float32
    _close(got, want)


def test_panoptic_losses_match_jax(panoptic):
    """With the labels: JAX's six losses in the port's order (the weight 0.5
    on loss_sem_seg); without: the same instance losses and no loss_sem_seg."""
    want, got = panoptic["want"]["losses"], panoptic["got"]
    assert list(got[True]) == ["loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask", "loss_sem_seg"]
    assert set(got[True]) == set(want) and list(got[False]) == list(got[True])[:-1]
    for k, v in want.items():
        assert abs(got[True][k] - v) <= TOL * abs(v), (k, got[True][k], v)
        if k != "loss_sem_seg":
            assert got[False][k] == got[True][k], k
    assert all(v > 0 for v in want.values()), want


def test_panoptic_inference_matches_jax(panoptic):
    """The detections (kept slots and classes exactly, boxes, scores and mask
    probabilities at 2e-4 of their largest) and sem_seg, the argmax at H/4."""
    want, got = panoptic["want"]["det"], panoptic["det"]
    assert sorted(got) == sorted(want) == ["boxes", "classes", "mask_probs", "scores", "sem_seg", "valid"]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    assert got["valid"].sum() > 0
    for k in ("boxes", "scores", "mask_probs"):
        _close(got[k], want[k], rtol=0, atol=2e-4)
    assert got["sem_seg"].shape == want["sem_seg"].shape == (2, H // 4, W // 4)
    _argmax_agrees(got["sem_seg"], want["sem_seg"], panoptic["want"]["logits"])


def test_semantic_segmentor_matches_jax(semseg):
    """The loss (ignored pixels left out), the logits and the argmax."""
    (want_loss, want_logits, want_argmax), (got_loss, got_logits, got_argmax) = semseg["want"], semseg["got"]
    assert abs(got_loss - want_loss) <= TOL * abs(want_loss) and want_loss > 0
    assert got_logits.shape == want_logits.shape == (2, H // 4, W // 4, SEM)
    _close(got_logits, want_logits)
    _argmax_agrees(got_argmax, want_argmax, want_logits)


def test_sem_seg_loss_of_all_ignored_is_zero():
    from vnext_tpu_torch.models.semantic_seg import sem_seg_loss

    logits = torch.randn(1, 3, 4, 4)
    assert float(sem_seg_loss(logits, torch.full((1, 4, 4), 255), 255)) == 0.0


def test_combine_semantic_and_instance_outputs_equals_jax():
    """Overlapping instances (one mostly covered, one under the score
    threshold, one empty), stuff regions above and below the area limit."""
    rng = np.random.RandomState(0)
    sem = rng.randint(0, 4, (60, 90))
    sem[:40, :70] = 2
    masks = np.zeros((6, 60, 90), bool)
    for i, (y, x, h, w) in enumerate([(5, 5, 30, 40), (10, 10, 25, 35), (30, 40, 25, 45), (0, 0, 10, 10),
                                      (50, 80, 10, 10), (0, 0, 0, 0)]):
        masks[i, y:y + h, x:x + w] = True
    scores = np.asarray([0.9, 0.8, 0.7, 0.3, 0.95, 0.6], np.float32)
    classes = np.asarray([1, 2, 3, 0, 5, 2])
    for limit in (64, 1000):
        got = combine_semantic_and_instance_outputs(sem, masks, scores, classes, stuff_area_limit=limit)
        want = jax_combine(sem, masks, scores, classes, stuff_area_limit=limit)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        assert any(s["isthing"] for s in got[1]) and any(not s["isthing"] for s in got[1])


# ---------------------------------------------------------------- the evaluators
def _hand_made_panoptic():
    """Two images' ground truth and prediction id maps with void (0), a crowd
    segment, a false positive mostly on void, one lying on the crowd, a
    match, a miss and a category mismatch."""
    gt = np.zeros((2, 40, 60), np.int64)
    gt[0, :20, :30], gt[0, :20, 30:], gt[0, 20:35, :] = 1, 2, 3          # rows 35.. void
    gt[1, :, :30], gt[1, :, 30:50] = 4, 5                                # 5 is a crowd
    segs_gt = [[{"id": 1, "category_id": 1}, {"id": 2, "category_id": 7}, {"id": 3, "category_id": 2}],
               [{"id": 4, "category_id": 1}, {"id": 5, "category_id": 3, "iscrowd": 1}]]
    pred = np.zeros((2, 40, 60), np.int64)
    pred[0, :22, :28], pred[0, :20, 28:], pred[0, 30:, :] = 11, 12, 13
    pred[1, :, :25], pred[1, :, 32:48], pred[1, :10, 50:] = 21, 22, 23
    segs_pred = [[{"id": 11, "category_id": 1}, {"id": 12, "category_id": 8}, {"id": 13, "category_id": 2}],
                 [{"id": 21, "category_id": 1}, {"id": 22, "category_id": 3}, {"id": 23, "category_id": 9}]]
    return gt, segs_gt, pred, segs_pred


def test_pq_single_image_and_panoptic_evaluator_equal_jax():
    gt, segs_gt, pred, segs_pred = _hand_made_panoptic()
    got_stats, want_stats = {}, {}
    for i in range(2):
        pq_single_image(gt[i], segs_gt[i], pred[i], segs_pred[i], got_stats)
        jax_pq_single_image(gt[i], segs_gt[i], pred[i], segs_pred[i], want_stats)
    assert sorted(got_stats) == sorted(want_stats)
    for c in want_stats:
        np.testing.assert_array_equal(got_stats[c], want_stats[c])
    for thing_ids in (None, {1, 7, 8}):
        records = [{"pan_seg": gt[i], "segments_info": segs_gt[i]} for i in range(2)]
        outputs = [{"panoptic_seg": (pred[i], segs_pred[i])} for i in range(2)]
        got, want = COCOPanopticEvaluator(thing_ids), JaxPanopticEvaluator(thing_ids)
        got.process(records, outputs)
        want.process(records, outputs)
        assert got.evaluate() == want.evaluate()
        assert 0 < got.evaluate()["panoptic_seg"]["PQ"] < 100


def test_sem_seg_evaluator_equals_jax():
    """Ignored pixels, predictions outside [0, C) (clipped), a class never in
    the ground truth, named classes."""
    rng = np.random.RandomState(3)
    records, outputs = [], []
    for _ in range(3):
        gt = rng.randint(0, 4, (20, 30))
        gt[rng.rand(20, 30) < 0.2] = 255
        pred = np.where(rng.rand(20, 30) < 0.6, gt, rng.randint(-1, 7, (20, 30)))
        records.append({"sem_seg_gt": gt})
        outputs.append({"sem_seg": pred})
    for names in (None, ["a", "b", "c", "d", "e"]):
        got, want = SemSegEvaluator(5, class_names=names), JaxSemSegEvaluator(5, class_names=names)
        got.process(records, outputs)
        want.process(records, outputs)
        assert got.evaluate() == want.evaluate()


# ---------------------------------------------------------------- the panoptic json
def test_id_encoding_and_loader_equal_jax(tmp_path):
    ids = np.random.RandomState(4).randint(0, 256 ** 3, (7, 9))
    rgb = coco_panoptic.id2rgb(ids)
    np.testing.assert_array_equal(rgb, jax_coco_panoptic.id2rgb(ids))
    np.testing.assert_array_equal(coco_panoptic.rgb2id(rgb), ids)
    np.testing.assert_array_equal(coco_panoptic.rgb2id(rgb), jax_coco_panoptic.rgb2id(rgb))
    np.testing.assert_array_equal(coco_panoptic.rgb2id(ids), jax_coco_panoptic.rgb2id(ids))
    register_synthetic_panoptic("panoptic_written", root=str(tmp_path), num_images=3, h=40, w=56)
    meta = MetadataCatalog.get("panoptic_written")
    got = coco_panoptic.load_coco_panoptic_json(meta.panoptic_json, meta.image_root, meta.panoptic_root)
    want = jax_coco_panoptic.load_coco_panoptic_json(meta.panoptic_json, meta.image_root, meta.panoptic_root)
    assert got == want and len(got) == 3
    # without "images" in the json, the image's name from the PNG's
    with open(meta.panoptic_json) as f:
        data = json.load(f)
    del data["images"]
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(data))
    assert (coco_panoptic.load_coco_panoptic_json(str(bare), "i", "p")
            == jax_coco_panoptic.load_coco_panoptic_json(str(bare), "i", "p"))
    # the separated records: the same, plus the instances and the stuff PNG
    records = DatasetCatalog.get("panoptic_written")
    for r, w in zip(records, want):
        assert {k: r[k] for k in w} == w
        assert r["annotations"] and os.path.exists(r["sem_seg_file_name"])
        pan = coco_panoptic.rgb2id(np.asarray(Image.open(r["pan_seg_file_name"])))
        assert sorted(np.unique(pan)[1:]) == sorted(s["id"] for s in r["segments_info"])
        assert MetadataCatalog.get("panoptic_written_sem_seg").evaluator_type == "sem_seg"
    with pytest.raises(ValueError, match="both"):
        coco_panoptic.register_coco_panoptic("half", {}, "i", "p", "j", instances_json="x")


# ---------------------------------------------------------------- repair (a): the mapper's semantic ground truth
def _records(tmp_path):
    register_synthetic_panoptic("panoptic_mapped", root=str(tmp_path), num_images=3, h=60, w=80)
    return DatasetCatalog.get("panoptic_mapped")


def test_mapper_sem_seg_repair(tmp_path):
    """JAX's mapper writes no ``sem_seg``, so JAX's adapter for
    SemanticSegmentor raises ``KeyError``. The port's: without the file,
    bit-equal to JAX's batch; with it, the same plus the label PNG carried
    through JAX's own transforms (``AugInput.transform``), padded with 255
    and taken to H/4 by JAX's ``_resize_nearest``."""
    records = _records(tmp_path)
    kw = dict(min_sizes=(48, 64), max_size=120, max_insts=4, target_size=(64, 112), mask_on=True)
    port, jmapper = DetectionDatasetMapper(**kw), JaxMapper(**kw)
    for seed, record in enumerate(records):
        bare = {k: v for k, v in record.items() if k != "sem_seg_file_name"}
        want = jmapper(record, random.Random(seed))
        assert "sem_seg" not in want
        got_bare, got = port(bare, random.Random(seed)), port(record, random.Random(seed))
        assert sorted(got_bare) == sorted(want) and sorted(got) == sorted([*want, "sem_seg"])
        for k in want:
            np.testing.assert_array_equal(np.asarray(got_bare[k]), np.asarray(want[k]))
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
        tfms = jmapper.aug.build(record["height"], record["width"], random.Random(seed))
        aug = JaxAugInput(np.asarray(Image.open(record["file_name"])),
                          sem_seg=np.asarray(Image.open(record["sem_seg_file_name"])))
        aug.transform(tfms)
        h, w = want["size"]
        padded = np.full((64, 112), 255, np.int32)
        padded[:h, :w] = aug.sem_seg[:h, :w]
        expected = jax_detection._resize_nearest(padded, (16, 28))
        np.testing.assert_array_equal(got["sem_seg"], expected)
        np.testing.assert_array_equal(expected, padded[::4, ::4])
        assert (got["sem_seg"] == 255).any() and (got["sem_seg"] < 255).any()
    batch = stack_detection_batch([port(r, random.Random(0)) for r in records[:2]])
    assert batch["sem_seg"].shape == (2, 16, 28)
    jcfg = jax_get_cfg()
    jax_add_idol_config(jcfg)
    jcfg.MODEL.META_ARCHITECTURE = "SemanticSegmentor"
    with pytest.raises(KeyError, match="sem_seg"):
        jax_detection.make_batch_adapter(jcfg)(jax_stack_detection_batch([jmapper(records[0], random.Random(0))]))
    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.MODEL.META_ARCHITECTURE = "SemanticSegmentor"
    images, labels = detection.make_batch_adapter(cfg, "cpu")(batch)
    assert tuple(images.shape) == (2, 64, 112, 3) and torch.equal(labels, torch.from_numpy(batch["sem_seg"]))
    cfg.MODEL.META_ARCHITECTURE = "PanopticFPN"
    inputs = detection.make_batch_adapter(cfg, "cpu")(batch)
    assert len(inputs) == 5 and torch.equal(inputs[4], labels)


# ---------------------------------------------------------------- repair (b): the panoptic and semantic outputs
class _Served(torch.nn.Module):
    """A model whose ``inference`` returns given outputs (the runners'
    post-processing alone is compared)."""

    def __init__(self, out):
        super().__init__()
        self.out = out
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def inference(self, *args):
        return self.out


def test_runner_and_evaluators_panoptic_repair(panoptic, tmp_path):
    """JAX's runner makes no ``panoptic_seg`` and its evaluators read
    ``pan_seg`` / ``sem_seg_gt``, which no loader gives: ``KeyError``. The
    port's runner, on the same forward outputs: JAX's sem_seg and masks
    exactly, and panoptic_seg = JAX's fusion of them over the kept
    detections. The port's evaluators on records with the arrays equal
    JAX's; on the loader's records (the PNGs) the same dicts."""
    records = _records(tmp_path)[:2]
    cfgs = []
    for get, add in ((jax_get_cfg, jax_add_idol_config), (get_cfg, add_idol_config)):
        cfg = get()
        add(cfg)
        cfg.merge_from_list(["MODEL.META_ARCHITECTURE", "PanopticFPN", "TPU.TEST_IMAGE_SIZE", [H, W],
                             "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96])
        cfgs.append(cfg)
    det = panoptic["want"]["det"]
    jax_runner = jax_detection.DetectionInference(cfgs[0], model=JaxPanopticFPN(**PAN), params={})
    outputs, want_outputs = [], []
    for i, record in enumerate(records):
        one = {k: v[i:i + 1] for k, v in det.items()}
        jax_runner._infer = lambda params, images, sizes, one=one: one
        want_outputs.append(jax_runner(record))
        runner = detection.DetectionInference(cfgs[1], _Served({k: torch.from_numpy(v) for k, v in one.items()}))
        outputs.append(runner(record))
    jax_pan, jax_sem = JaxPanopticEvaluator({0, 1, 2, 3}), JaxSemSegEvaluator(SEM)
    with pytest.raises(KeyError, match="panoptic_seg"):
        jax_pan.process(records[:1], want_outputs[:1])
    with pytest.raises(KeyError, match="pan_seg"):
        jax_pan.process(records[:1], outputs[:1])
    with pytest.raises(KeyError, match="sem_seg_gt"):
        jax_sem.process(records[:1], want_outputs[:1])
    for got, want, record in zip(outputs, want_outputs, records):
        assert sorted(got) == sorted([*want, "panoptic_seg"])
        np.testing.assert_array_equal(got["sem_seg"], want["sem_seg"])
        assert got["sem_seg"].shape == (record["height"], record["width"])
        np.testing.assert_array_equal(got["masks"], want["masks"])
        kept = want["valid"]
        pan, segments = jax_combine(want["sem_seg"], want["masks"][kept], want["scores"][kept], want["classes"][kept])
        np.testing.assert_array_equal(got["panoptic_seg"][0], pan)
        assert got["panoptic_seg"][1] == segments and segments
    # with the arrays in the records, JAX's evaluators run: the port's dicts equal theirs, and equal the ones the
    # port reads from the files
    with_arrays = [dict(r, pan_seg=coco_panoptic.rgb2id(np.asarray(Image.open(r["pan_seg_file_name"]))),
                        sem_seg_gt=np.asarray(Image.open(r["sem_seg_file_name"]))) for r in records]
    for port_cls, jax_cls, args in ((COCOPanopticEvaluator, JaxPanopticEvaluator, ({0, 1, 2, 3},)),
                                    (SemSegEvaluator, JaxSemSegEvaluator, (SEM,))):
        want_ev, got_ev, from_files = jax_cls(*args), port_cls(*args), port_cls(*args)
        want_ev.process(with_arrays, outputs)
        got_ev.process(with_arrays, outputs)
        from_files.process(records, outputs)
        assert got_ev.evaluate() == want_ev.evaluate() == from_files.evaluate()


def test_build_evaluator_serves_panoptic_and_sem_seg(tmp_path):
    _records(tmp_path)
    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_list(["MODEL.MASK_ON", "True", "OUTPUT_DIR", str(tmp_path)])
    combined = build_evaluator(cfg, "panoptic_mapped")
    assert isinstance(combined, DatasetEvaluators)
    coco, pan = combined._evaluators
    assert coco._tasks == ("bbox", "segm") and pan._thing_ids == {0, 1, 2}
    sem = build_evaluator(cfg, "panoptic_mapped_sem_seg")
    assert isinstance(sem, SemSegEvaluator) and sem._num_classes == 4 and sem._ignore_label == 255


# ---------------------------------------------------------------- the builders and the entry point
def test_build_model_from_the_panoptic_yaml():
    """The yaml's full widths on the meta device: PanopticFPN in bf16 with
    the 54-class head at weight 0.5, SemanticSegmentor in f32 (as JAX's
    builder makes it)."""
    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file(PANOPTIC_YAML)
    model = build_model(cfg, device="meta")
    assert type(model).__name__ == "PanopticFPN" and model.dtype == torch.bfloat16 and model.mask_on
    assert model.sem_seg_head.predictor.weight.shape[0] == 54 and model.sem_seg_loss_weight == 0.5
    cfg.MODEL.META_ARCHITECTURE = "SemanticSegmentor"
    model = build_model(cfg, device="meta")
    assert type(model).__name__ == "SemanticSegmentor" and model.dtype == torch.float32
    assert model.num_classes == 54 and model.fpn.top_block == "none"


TRAIN_NET_TINY = ["MODEL.DEVICE", "cpu", "TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.DEPTH", "18",
                  "MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_HEADS.NUM_CLASSES", "3", "MODEL.SEM_SEG_HEAD.NUM_CLASSES",
                  "4", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "64",
                  "INPUT.MIN_SIZE_TRAIN", "(96,)", "INPUT.MAX_SIZE_TRAIN", "128", "INPUT.MIN_SIZE_TEST", "96",
                  "INPUT.MAX_SIZE_TEST", "128", "TPU.TRAIN_IMAGE_SIZE", "[96, 128]", "TPU.TEST_IMAGE_SIZE", "[96, 128]",
                  "TPU.MAX_INSTANCES", "8", "TEST.DETECTIONS_PER_IMAGE", "16", "SOLVER.IMS_PER_BATCH", "2",
                  "SOLVER.MAX_ITER", "1"]


@pytest.mark.parametrize("arch", ["PanopticFPN", "SemanticSegmentor"])
@pytest.mark.parametrize("eval_only", [True, False], ids=["eval_only", "train"])
def test_train_net_runs(arch, eval_only, tmp_path, monkeypatch):
    """``train_net.main`` on the panoptic yaml at a tiny size: --eval-only
    scored by the COCO and panoptic evaluators (PanopticFPN) or the
    semantic one (SemanticSegmentor, on the set's sem_seg twin); one train
    step with every loss finite, loss_sem_seg included, then the evaluation."""
    register_synthetic_panoptic("panoptic_entry", root=str(tmp_path / "data"), num_images=3, h=72, w=96)
    name = "panoptic_entry" if arch == "PanopticFPN" else "panoptic_entry_sem_seg"
    argv = ["--config-file", PANOPTIC_YAML, *(["--eval-only"] if eval_only else []), *TRAIN_NET_TINY,
            "MODEL.META_ARCHITECTURE", arch, "DATASETS.TRAIN", f"('{name}',)", "DATASETS.TEST", f"('{name}',)",
            "OUTPUT_DIR", str(tmp_path / "out")]
    evaluated, do_eval = [], detection.do_eval_detection
    monkeypatch.setattr(detection, "do_eval_detection", lambda *a, **kw: evaluated.append(do_eval(*a, **kw))
                        or evaluated[-1])
    out = train_net.main(argv)
    if not eval_only:
        hist = out.storage.histories()
        keys = [k for k in hist if k.startswith("loss_")]
        cfg = get_cfg()
        add_idol_config(cfg)
        cfg.merge_from_file(PANOPTIC_YAML)
        cfg.MODEL.META_ARCHITECTURE = arch
        assert sorted(keys) == sorted(detection.loss_keys(cfg)) and "loss_sem_seg" in keys
        assert all(np.isfinite(hist[k].values()).all() for k in keys + ["total_loss"])
    assert len(evaluated) == (0 if eval_only else 1)         # the evaluation after the last step
    results = (out if eval_only else evaluated[0])[name]
    tasks = {"PanopticFPN": ["bbox", "panoptic_seg", "segm"], "SemanticSegmentor": ["sem_seg"]}[arch]
    assert sorted(results) == tasks
    stats = results["panoptic_seg" if arch == "PanopticFPN" else "sem_seg"]
    keys = (["PQ", "SQ", "RQ", "PQ_th", "SQ_th", "RQ_th", "PQ_st", "SQ_st", "RQ_st"] if arch == "PanopticFPN"
            else ["mIoU", "fwIoU", "pACC", "mACC"])
    assert all(np.isfinite(stats[k]) and 0 <= stats[k] <= 100 for k in keys), stats
