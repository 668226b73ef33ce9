"""LVIS, Pascal VOC and Cityscapes in the port against the JAX package, on the
CPU: the loaders, the builtin registry, the four evaluators, the mapper's box
modes, the weights bridge at the configs' class counts and the entry point on
the four yamls.

The data are the synthetic sets of ``data/datasets/synthetic.py``, written
from seeds in each dataset's own layout under one root (LVIS v1 / v0.5 jsons
with all 1203 / 1230 categories, VOC2007 / VOC2012 XML and split lists with
``difficult`` objects, Cityscapes' leftImg8bit PNGs with 16-bit instance ids
and uint8 train ids), small so that the file stays quick. The records, the
metadata and the evaluators' dicts equal JAX's (within 1e-12 where they are
floats), but for the ``bbox_mode`` the port's VOC and Cityscapes records add.

Three faults of the JAX package lie on this path (ROADMAP Queue 3, item 7 for
the first two, item 5 for the third). JAX's mapper reads every box as XYWH, so
it puts a VOC or Cityscapes box [x0, y0, x1, y1] at [x0, y0, x0 + x1, y0 + y1];
the port's reads the record's mode and leaves COCO-form records bit-equal.
JAX's ``tools/train_net.py`` registers COCO's splits alone, so the LVIS, VOC
and Cityscapes yamls name datasets it cannot find; the port's entry point
registers every builtin split under ``$VNEXT_DATASETS``. Both loaders ignore
``DATALOADER.SAMPLER_TRAIN``; the port's says so once.
"""

import importlib.util
import logging
import os
import random
import sys

import jax
import numpy as np
import pytest
import torch

from vnext_tpu.data.catalog import DatasetCatalog as JaxDatasetCatalog
from vnext_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from vnext_tpu.data.datasets import builtin as jax_builtin
from vnext_tpu.data.datasets import cityscapes as jax_cityscapes
from vnext_tpu.data.datasets import lvis as jax_lvis
from vnext_tpu.data.datasets import pascal_voc as jax_voc
from vnext_tpu.data.detection_mapper import DetectionDatasetMapper as JaxMapper
from vnext_tpu.evaluation.cityscapes_eval import CityscapesInstanceEvaluator as JaxCityInstance
from vnext_tpu.evaluation.cityscapes_eval import CityscapesSemSegEvaluator as JaxCitySemSeg
from vnext_tpu.evaluation.lvis_eval import LVISEvaluator as JaxLVISEvaluator
from vnext_tpu.evaluation.pascal_voc_eval import PascalVOCDetectionEvaluator as JaxVOCEvaluator
from vnext_tpu.evaluation.pascal_voc_eval import voc_ap as jax_voc_ap
from vnext_tpu.models.rcnn import GeneralizedRCNN as JaxRCNN
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.config import add_idol_config, get_cfg
from vnext_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from vnext_tpu_torch.data.datasets import builtin, cityscapes, lvis, pascal_voc, synthetic
from vnext_tpu_torch.data.detection_mapper import DetectionDatasetMapper
from vnext_tpu_torch.engine import detection
from vnext_tpu_torch.evaluation.cityscapes_eval import CityscapesInstanceEvaluator, CityscapesSemSegEvaluator
from vnext_tpu_torch.evaluation.lvis_eval import LVISEvaluator
from vnext_tpu_torch.evaluation.pascal_voc_eval import PascalVOCDetectionEvaluator, voc_ap
from vnext_tpu_torch.evaluation.rle import rle_decode
from vnext_tpu_torch.evaluation.ytvis_eval import build_evaluator
from vnext_tpu_torch.models.rcnn import GeneralizedRCNN
from vnext_tpu_torch.structures.boxes import BoxMode
from vnext_tpu_torch.tools import train_net

from _torch_helpers import random_params

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = {
    "lvis_v1": ("configs/LVISv1-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml", 1203, True),
    "lvis_v0.5": ("configs/LVISv0.5-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml", 1230, True),
    "voc": ("configs/PascalVOC-Detection/faster_rcnn_R_50_FPN.yaml", 20, False),
    "cityscapes": ("configs/Cityscapes/mask_rcnn_R_50_FPN.yaml", 8, True),
}
# every name the builtin registries give, the JAX package's and the port's alike
ALL_BUILTIN = tuple(builtin.BUILTIN_NAMES)
TOL = 1e-12


def _forget(names):
    for catalogs in ((DatasetCatalog, MetadataCatalog), (JaxDatasetCatalog, JaxMetadataCatalog)):
        for catalog in catalogs:
            for name in names:
                if name in catalog:
                    catalog.remove(name)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The synthetic LVIS, VOC and Cityscapes sets under one root, named by
    ``$VNEXT_DATASETS``; the builtin names are forgotten by both catalogs
    before and after (another test may have registered them elsewhere)."""
    path = str(tmp_path_factory.mktemp("datasets"))
    synthetic.generate_synthetic_lvis(path, num_train=2, num_val=3, h=72, w=96, seed=1)
    synthetic.generate_synthetic_voc(path, num_train=1, num_val=1, num_test=3, h=75, w=100, seed=2)
    synthetic.generate_synthetic_cityscapes(path, num_train=2, num_val=3, h=64, w=128, seed=3)
    _forget(ALL_BUILTIN)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VNEXT_DATASETS", path)
        yield path
    _forget(ALL_BUILTIN)


def _without_mode(records):
    """Records with the port's added ``bbox_mode`` taken out of each annotation."""
    out = []
    for r in records:
        anns = [{k: v for k, v in a.items() if k != "bbox_mode"} for a in r.get("annotations", [])]
        out.append({**r, "annotations": anns} if "annotations" in r else dict(r))
    return out


def _equal_stats(got, want):
    assert got.keys() == want.keys()
    for task in want:
        assert got[task].keys() == want[task].keys(), task
        for k, v in want[task].items():
            assert (np.isnan(v) and np.isnan(got[task][k])) or abs(got[task][k] - v) <= TOL, (task, k)


# ---------------------------------------------------------------- the loaders and the registry
@pytest.mark.parametrize("kind", ["voc_2007_test", "voc_2012_trainval", "lvis_v1_val", "lvis_v0.5_train",
                                  "cityscapes_instance", "cityscapes_sem_seg"])
def test_loaders_equal_jax(root, kind):
    """Each loader's records and metadata equal JAX's on the same files, but
    for the port's ``bbox_mode``: XYXY_ABS on every VOC and Cityscapes
    instance annotation, none on LVIS's (COCO's XYWH)."""
    if kind.startswith("voc"):
        year, split = kind.split("_")[1:]
        args = (os.path.join(root, f"VOC{year}"), split)
        got, want = pascal_voc.load_voc_instances(*args), jax_voc.load_voc_instances(*args)
        assert any(a["difficult"] for r in got for a in r["annotations"]) or split != "test"
    elif kind.startswith("lvis"):
        name = f"extra_{kind}"
        _forget([name])
        args = (os.path.join(root, "lvis", f"{kind}.json"), os.path.join(root, "coco"), name)
        got, want = lvis.load_lvis_json(*args), jax_lvis.load_lvis_json(*args)
        meta, jax_meta = MetadataCatalog.get(name), JaxMetadataCatalog.get(name)
        n = {"lvis_v1_val": 1203, "lvis_v0.5_train": 1230}[kind]
        assert len(meta.thing_classes) == n and meta.class_frequencies.count("r") > 0
        for key in ("thing_classes", "class_frequencies", "thing_dataset_id_to_contiguous_id"):
            assert meta.get(key) == jax_meta.get(key), key
        assert all(os.path.exists(r["file_name"]) and r["neg_category_ids"] for r in got)
        _forget([name])
    else:
        args = (os.path.join(root, "cityscapes", "leftImg8bit", "val"), os.path.join(root, "cityscapes", "gtFine",
                                                                                    "val"))
        if kind == "cityscapes_instance":
            got, want = cityscapes.load_cityscapes_instances(*args), jax_cityscapes.load_cityscapes_instances(*args)
            a = got[0]["annotations"][0]
            x0, y0, x1, y1 = a["bbox"]
            mask = rle_decode(a["segmentation"])
            assert mask.any(axis=1).nonzero()[0][[0, -1]].tolist() == [y0, y1 - 1]
            assert mask.any(axis=0).nonzero()[0][[0, -1]].tolist() == [x0, x1 - 1]
        else:
            got, want = cityscapes.load_cityscapes_semantic(*args), jax_cityscapes.load_cityscapes_semantic(*args)
        assert all(isinstance(r["image_id"], str) and r["image_id"].startswith("frankfurt_") for r in got)
    assert len(got) > 0 and sum(len(r.get("annotations", [1])) for r in got) > 0
    modes = {a.get("bbox_mode") for r in got for a in r.get("annotations", [])}
    assert modes == ({None} if kind.startswith("lvis") else {BoxMode.XYXY_ABS} if modes else set())
    assert _without_mode(got) == want


def test_builtin_registry_equals_jax(root):
    """``register_all_builtin`` under one root: every name of JAX's, the same
    paths, splits, years and evaluator types; the yamls' own names load."""
    names_before = set(DatasetCatalog.list()), set(JaxDatasetCatalog.list())
    builtin.register_all_builtin(root)
    jax_builtin.register_all_builtin(root)
    new = set(DatasetCatalog.list()) - names_before[0]
    assert new == set(JaxDatasetCatalog.list()) - names_before[1]
    assert set(ALL_BUILTIN) <= new | names_before[0]
    for name in sorted(new):
        assert MetadataCatalog.get(name).as_dict() == JaxMetadataCatalog.get(name).as_dict(), name
    types = {n: MetadataCatalog.get(n).evaluator_type for n in ALL_BUILTIN}
    assert types["lvis_v0.5_val"] == "lvis" and types["voc_2007_test"] == "pascal_voc"
    assert types["cityscapes_fine_sem_seg_val"] == "cityscapes_sem_seg"
    assert MetadataCatalog.get("voc_2012_val").year == 2012
    for name in ("lvis_v1_train", "voc_2012_trainval", "cityscapes_fine_instance_seg_train"):
        assert len(DatasetCatalog.get(name)) >= 1
    _forget(new)


# ---------------------------------------------------------------- the evaluators
def _detections(rng, boxes, classes, n_classes, h, w, n_extra=4):
    """Outputs near the ground truth (jittered copies, some relabelled) and
    random extra boxes, with masks of the boxes."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    near = boxes + rng.uniform(-3, 3, boxes.shape)
    cls = np.asarray(classes, np.int64).copy()
    flip = rng.rand(len(cls)) < 0.25
    cls[flip] = rng.randint(n_classes, size=int(flip.sum()))
    x0, y0 = rng.uniform(0, w - 8, n_extra), rng.uniform(0, h - 8, n_extra)
    extra = np.stack([x0, y0, x0 + rng.uniform(4, w / 2, n_extra), y0 + rng.uniform(4, h / 2, n_extra)], 1)
    out_boxes = np.clip(np.concatenate([near, extra]), 0, [w, h, w, h])
    classes = np.concatenate([cls, rng.randint(n_classes, size=n_extra)])
    scores = rng.rand(len(out_boxes))
    masks = np.zeros((len(out_boxes), h, w), bool)
    for i, (a, b, c, d) in enumerate(np.round(out_boxes).astype(int)):
        masks[i, b:d, a:c] = True
    valid = rng.rand(len(out_boxes)) < 0.9
    return {"boxes": out_boxes.astype(np.float32), "scores": scores.astype(np.float32), "classes": classes,
            "valid": valid, "masks": masks}


@pytest.mark.parametrize("use_07", [True, False], ids=["voc07", "voc12"])
def test_voc_evaluator_equals_jax(root, use_07):
    """AP50 by class and its mean on VOC2007's test records (difficult objects
    among them), both metrics; ``voc_ap`` on random curves."""
    rng = np.random.RandomState(4)
    records = pascal_voc.load_voc_instances(os.path.join(root, "VOC2007"), "test")
    outputs = [_detections(rng, [a["bbox"] for a in r["annotations"]], [a["category_id"] for a in r["annotations"]],
                           20, r["height"], r["width"]) for r in records]
    got, want = PascalVOCDetectionEvaluator(list(pascal_voc.CLASS_NAMES), use_07), JaxVOCEvaluator(
        list(pascal_voc.CLASS_NAMES), use_07)
    for ev in (got, want):
        ev.reset()
        for r, o in zip(records, outputs):
            ev.process([r], [o])
    got, want = got.evaluate(), want.evaluate()
    _equal_stats(got, want)
    assert 0 < got["bbox"]["AP50"] <= 100
    rec = np.sort(rng.rand(9))
    prec = rng.rand(9)
    assert abs(voc_ap(rec, prec, use_07) - jax_voc_ap(rec, prec, use_07)) <= TOL


def test_lvis_evaluator_equals_jax(root, tmp_path):
    """bbox and segm AP with APr / APc / APf on the LVIS v1 val json's 1203
    categories (each band holds ground truth)."""
    rng = np.random.RandomState(5)
    json_file = os.path.join(root, "lvis", "lvis_v1_val.json")
    records = lvis.load_lvis_json(json_file, os.path.join(root, "coco"))
    name = "extra_lvis_eval"
    _forget([name])
    id_map = {i + 1: i for i in range(1203)}
    for catalog in (MetadataCatalog, JaxMetadataCatalog):
        catalog.get(name).set(json_file=json_file, thing_dataset_id_to_contiguous_id=id_map)
    outputs = []
    for r in records:
        xyxy = [[x, y, x + bw, y + bh] for x, y, bw, bh in (a["bbox"] for a in r["annotations"])]
        outputs.append(_detections(rng, xyxy, [a["category_id"] - 1 for a in r["annotations"]], 1203, r["height"],
                                   r["width"]))
    results = []
    for cls in (LVISEvaluator, JaxLVISEvaluator):
        ev = cls(name, tasks=("bbox", "segm"), output_dir=str(tmp_path / cls.__module__))
        ev.reset()
        for r, o in zip(records, outputs):
            ev.process([r], [o])
        results.append(ev.evaluate())
    _equal_stats(*results)
    assert all(k in results[0][t] for t in ("bbox", "segm") for k in ("APr", "APc", "APf"))
    assert results[0]["bbox"]["AP"] > 0
    _forget([name])


def test_cityscapes_evaluators_equal_jax(root):
    """Mask AP over one-frame videos keyed by the string image ids, and mIoU
    from the labelTrainIds PNGs."""
    rng = np.random.RandomState(6)
    args = (os.path.join(root, "cityscapes", "leftImg8bit", "val"), os.path.join(root, "cityscapes", "gtFine", "val"))
    records = cityscapes.load_cityscapes_instances(*args)
    outputs = [_detections(rng, [a["bbox"] for a in r["annotations"]], [a["category_id"] for a in r["annotations"]],
                           8, r["height"], r["width"]) for r in records]
    for o, r in zip(outputs, records):   # the ground truth's own masks for the first detections
        for i, a in enumerate(r["annotations"][:2]):
            o["masks"][i] = rle_decode(a["segmentation"])
    names = [n for n, _ in cityscapes.CITYSCAPES_THING_CLASSES]
    results = []
    for cls in (CityscapesInstanceEvaluator, JaxCityInstance):
        ev = cls(class_names=names)
        ev.reset()
        for r, o in zip(records, outputs):
            ev.process([r], [o])
        results.append(ev.evaluate())
    _equal_stats(*results)
    assert results[0]["segm"]["AP"] > 0

    sem = cityscapes.load_cityscapes_semantic(*args)
    preds = [{"sem_seg": rng.randint(19, size=(r_["height"], r_["width"]))} for r_ in records]
    results = []
    for cls in (CityscapesSemSegEvaluator, JaxCitySemSeg):
        ev = cls()
        ev.reset()
        for r, p in zip(sem, preds):
            ev.process([r], [p])
        results.append(ev.evaluate())
    _equal_stats(*results)


def test_build_evaluator_dispatches_every_type(root, tmp_path):
    """The builtin splits' types make their evaluators (LVIS with segm under
    MASK_ON; VOC07's metric for 2007 only); ``rotated_coco`` builds the
    rotated evaluator (tests/test_torch_rotated.py holds it against JAX)."""
    builtin.register_all_builtin()
    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_list(["MODEL.MASK_ON", "True", "OUTPUT_DIR", str(tmp_path)])
    ev = build_evaluator(cfg, "lvis_v1_val")
    assert isinstance(ev, LVISEvaluator) and ev._tasks == ("bbox", "segm")
    assert build_evaluator(cfg, "voc_2007_test")._use_07 and not build_evaluator(cfg, "voc_2012_val")._use_07
    assert isinstance(build_evaluator(cfg, "cityscapes_fine_instance_seg_val"), CityscapesInstanceEvaluator)
    sem = build_evaluator(cfg, "cityscapes_fine_sem_seg_val")
    assert isinstance(sem, CityscapesSemSegEvaluator) and sem._num_classes == 19
    MetadataCatalog.get("extra_rotated_kind").set(evaluator_type="rotated_coco")
    assert type(build_evaluator(cfg, "extra_rotated_kind")).__name__ == "RotatedCOCOEvaluator"


# ---------------------------------------------------------------- the mapper (fault 1)
def test_mapper_reads_box_modes(root):
    """JAX's mapper puts a VOC box [x0, y0, x1, y1] at [x0, y0, x0 + x1,
    y0 + y1] (clipped to the padded image); the port's puts it at the XML's
    box under the same transforms. COCO-form LVIS records, which name no
    mode, give batches bit-equal to JAX's."""
    record = pascal_voc.load_voc_instances(os.path.join(root, "VOC2007"), "test")[0]
    kwargs = dict(is_train=False, min_sizes=(150,), max_size=400, target_size=(160, 224), max_insts=8)
    got, want = DetectionDatasetMapper(**kwargs)(record), JaxMapper(**kwargs)(record)
    tfms = DetectionDatasetMapper(**kwargs).aug.build(record["height"], record["width"], random.Random(0))
    n = len(record["annotations"])
    xyxy = np.asarray([a["bbox"] for a in record["annotations"]], np.float64)
    wide = np.concatenate([xyxy[:, :2], xyxy[:, :2] + xyxy[:, 2:]], 1)
    np.testing.assert_array_equal(got["boxes"][:n], tfms.apply_box(xyxy).astype(np.float32))
    np.testing.assert_array_equal(want["boxes"][:n], np.clip(tfms.apply_box(wide), 0, [224, 160, 224, 160])
                                  .astype(np.float32))
    assert not np.array_equal(got["boxes"][:n], want["boxes"][:n])
    assert got["valid"][:n].all() and not got["valid"][n:].any()
    with pytest.raises(ValueError, match="XYXY_REL"):
        DetectionDatasetMapper(**kwargs)({**record, "annotations": [{**record["annotations"][0],
                                                                     "bbox_mode": BoxMode.XYXY_REL}]})

    lvis_records = lvis.load_lvis_json(os.path.join(root, "lvis", "lvis_v1_train.json"), os.path.join(root, "coco"))
    train = dict(min_sizes=(64, 80), max_size=128, target_size=(96, 128), max_insts=8, mask_on=True)
    for r in lvis_records:
        a, b = DetectionDatasetMapper(**train)(r, random.Random(9)), JaxMapper(**train)(r, random.Random(9))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# ---------------------------------------------------------------- the entry points (faults 2 and 3)
def test_jax_entry_point_cannot_find_the_yamls_datasets(root, tmp_path, monkeypatch):
    """JAX's ``tools/train_net.py`` registers COCO's splits alone: at its
    evaluation the LVIS yaml's test set is not in its catalog. The port's
    entry point registers it under ``$VNEXT_DATASETS`` and loads it."""
    import vnext_tpu.data.datasets.synthetic as jax_synthetic
    import vnext_tpu.engine.detection as jax_detection

    spec = importlib.util.spec_from_file_location("jax_train_net_extra", os.path.join(REPO, "tools", "train_net.py"))
    jax_train_net = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_train_net)
    seen = {}
    monkeypatch.setattr(jax_synthetic, "register_synthetic_coco", lambda *a, **kw: None)
    monkeypatch.setattr(jax_detection, "do_eval_detection",
                        lambda cfg: seen.update({n: n in JaxDatasetCatalog for n in cfg.DATASETS.TEST}))
    yaml = os.path.join(REPO, YAMLS["lvis_v1"][0])
    monkeypatch.setattr(sys, "argv", ["train_net.py", "--config-file", yaml, "--eval-only", "OUTPUT_DIR",
                                      str(tmp_path / "jax")])
    jax_train_net.main()
    assert seen == {"lvis_v1_val": False}
    with pytest.raises(KeyError, match="lvis_v1_val"):
        JaxDatasetCatalog.get("lvis_v1_val")

    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file(yaml)
    train_net._register_image_datasets(cfg)
    assert len(DatasetCatalog.get("lvis_v1_val")) == 3 and MetadataCatalog.get("lvis_v1_val").evaluator_type == "lvis"


def test_sampler_warning_logged_once(root, caplog):
    """The LVIS yamls' ``RepeatFactorTrainingSampler`` is not read on the
    detection path (TrainingSampler, as in JAX): one warning names the key;
    the default sampler gives none. VOC's two train sets are concatenated."""
    builtin.register_all_builtin()
    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file(os.path.join(REPO, YAMLS["lvis_v1"][0]))
    logger = logging.getLogger("vnext_tpu_torch")
    with caplog.at_level(logging.WARNING, logger="vnext_tpu_torch"), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(logger, "propagate", True)
        detection.build_detection_train_loader(cfg)
        cfg.merge_from_list(["DATALOADER.SAMPLER_TRAIN", "TrainingSampler"])
        detection.build_detection_train_loader(cfg)
    warned = [r for r in caplog.records if "SAMPLER_TRAIN" in r.getMessage()]
    assert len(warned) == 1 and "RepeatFactorTrainingSampler" in warned[0].getMessage()
    voc = get_cfg()
    add_idol_config(voc)
    voc.merge_from_file(os.path.join(REPO, YAMLS["voc"][0]))
    assert voc.DATASETS.TRAIN == ("voc_2007_trainval", "voc_2012_trainval")
    ids = {r["image_id"] for n in voc.DATASETS.TRAIN for r in DatasetCatalog.get(n)}
    assert any(i.startswith("2012_") for i in ids) and any(not i.startswith("2012_") for i in ids)


# ---------------------------------------------------------------- the weights bridge at the configs' classes
@pytest.mark.parametrize("kind", list(YAMLS))
def test_from_jax_at_the_configs_class_counts(kind):
    """A JAX R-CNN tree at the yaml's classes (1203, 1230, 20, 8; masks as the
    yaml says; a tiny trunk) loads into the port's model with no key left
    over, and the class-specific layers compute the tree's x @ K + b."""
    rel, n_classes, mask_on = YAMLS[kind]
    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file(os.path.join(REPO, rel))
    assert (cfg.MODEL.ROI_HEADS.NUM_CLASSES, cfg.MODEL.MASK_ON) == (n_classes, mask_on)
    tiny = dict(num_classes=n_classes, mask_on=mask_on, backbone_depth=18, fpn_channels=32, proposals_per_image=32,
                roi_batch_per_image=16, max_detections=8)
    jmodel = JaxRCNN(**tiny)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32),
                                               np.asarray([[64, 64]], np.int32), method=JaxRCNN.inference), seed=7)
    port = GeneralizedRCNN(**tiny).eval()
    load_from_jax(port, params)
    heads = params["roi_heads"]
    x = np.random.RandomState(8).randn(3, 1024).astype(np.float32)
    for layer, width in (("cls_score", n_classes + 1), ("bbox_pred", 4 * n_classes)):
        with torch.no_grad():
            got = getattr(port.roi_heads, layer)(torch.from_numpy(x)).numpy()
        want = x @ np.asarray(heads[layer]["kernel"]) + np.asarray(heads[layer]["bias"])
        assert got.shape == (3, width)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert ("mask_pred" in heads) == mask_on
    if mask_on:
        m = np.random.RandomState(9).randn(2, 256, 4, 4).astype(np.float32)
        with torch.no_grad():
            got = port.roi_heads.mask_pred(torch.from_numpy(m)).numpy()
        k = np.asarray(heads["mask_pred"]["kernel"])[0, 0]
        want = np.einsum("nchw,ck->nkhw", m, k) + np.asarray(heads["mask_pred"]["bias"])[:, None, None]
        assert got.shape == (2, n_classes, 4, 4)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- the entry point on the four yamls
TINY = ["MODEL.DEVICE", "cpu", "TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.DEPTH", "18", "MODEL.FPN.OUT_CHANNELS",
        "32", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
        "INPUT.MIN_SIZE_TRAIN", "(96,)", "INPUT.MAX_SIZE_TRAIN", "128", "INPUT.MIN_SIZE_TEST", "96",
        "INPUT.MAX_SIZE_TEST", "128", "TPU.TRAIN_IMAGE_SIZE", "[96, 128]", "TPU.TEST_IMAGE_SIZE", "[96, 128]",
        "TPU.MAX_INSTANCES", "8", "TEST.DETECTIONS_PER_IMAGE", "8", "SOLVER.IMS_PER_BATCH", "2"]
KEYS = {"lvis_v1": ("lvis_v1_val", {"bbox", "segm"}, "AP"), "lvis_v0.5": ("lvis_v0.5_val", {"bbox", "segm"}, "AP"),
        "voc": ("voc_2007_test", {"bbox"}, "AP50"), "cityscapes": ("cityscapes_fine_instance_seg_val", {"segm"}, "AP")}


@pytest.mark.parametrize("mode", ["eval_only", "train"])
@pytest.mark.parametrize("kind", list(YAMLS))
def test_train_net_runs_the_yamls(root, tmp_path, kind, mode):
    """``train_net.main`` on each yaml, its own ``DATASETS`` names resolved
    under ``$VNEXT_DATASETS``, at a tiny trunk and size but the yaml's
    classes: ``--eval-only`` returns its evaluator's dict (LVIS's AP with
    APr / APc / APf, VOC's AP50, Cityscapes' segm AP); 2 train steps of 2
    images, every loss finite (VOC's batches drawn from both its train sets),
    and for Cityscapes ``--resume`` for a third step."""
    rel, n_classes, _ = YAMLS[kind]
    argv = ["--config-file", os.path.join(REPO, rel), *TINY, "OUTPUT_DIR", str(tmp_path / "out")]
    name, tasks, key = KEYS[kind]
    if mode == "eval_only":
        results = train_net.main([*argv[:2], "--eval-only", *argv[2:]])
        assert list(results) == [name] and set(results[name]) == tasks
        for task in tasks:
            assert np.isfinite(results[name][task][key])
            if kind.startswith("lvis"):
                assert {"APr", "APc", "APf"} <= set(results[name][task])
        return
    trainer = train_net.main([*argv, "SOLVER.MAX_ITER", "2", "DATASETS.TEST", "()"])
    hist = trainer.storage.histories()
    assert trainer.iter == 2 and trainer.state.model.roi_heads.cls_score.weight.shape[0] == n_classes + 1
    keys = [k for k in hist if k.startswith("loss_")]
    assert sorted(keys) == sorted(detection.loss_keys(trainer_cfg(rel)))
    assert all(np.isfinite(hist[k].values()).all() for k in keys + ["total_loss"])
    if kind == "cityscapes":
        resumed = train_net.main(["--resume", *argv, "SOLVER.MAX_ITER", "3", "DATASETS.TEST", "()"])
        assert resumed.start_iter == 2 and resumed.iter == 3
        assert np.isfinite(resumed.storage.history("total_loss").values()).all()


def trainer_cfg(rel):
    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file(os.path.join(REPO, rel))
    return cfg
