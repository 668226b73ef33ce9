"""The port's YouTube-VIS data layer against the JAX package's, on the CPU.

The catalogs, the json loader, the synthetic generator (json and PNG pixels),
each transform, the clip mapper and the train loader must give exactly what the
JAX package gives for the same inputs and seeds: the host pipeline is numpy,
PIL and ``random.Random`` in both, so every array of every batch is held
bit-equal, not within a tolerance. The mapper runs at the quick-schedule
config's sizes (``configs/quick_schedules/idol_instant_test.yaml``, frames
128x192) with a crop range that cuts them, so that crops and flips are both
drawn. A mapper that raises in the loader's prefetch thread must raise at
``next()`` (the JAX package's loader ends instead; ROADMAP "Divergences kept
on purpose").
"""

import json
import os
import random

import numpy as np
import pytest
from PIL import Image

from vnext_tpu.config import add_idol_config as jax_add_idol_config
from vnext_tpu.config import get_cfg as jax_get_cfg
from vnext_tpu.data import build as jax_build
from vnext_tpu.data import catalog as jax_catalog
from vnext_tpu.data import transforms as jax_T
from vnext_tpu.data.dataset_mapper import YTVISDatasetMapper as JaxMapper
from vnext_tpu.data.datasets import synthetic as jax_synthetic
from vnext_tpu.data.datasets.ytvis import load_ytvis_json as jax_load_ytvis_json
from vnext_tpu.evaluation.rle import rle_encode as jax_rle_encode
from vnext_tpu.structures.masks import polygons_to_bitmask as jax_polygons_to_bitmask
from vnext_tpu_torch.config import add_idol_config, get_cfg
from vnext_tpu_torch.data import build, catalog
from vnext_tpu_torch.data import transforms as T
from vnext_tpu_torch.data.dataset_mapper import YTVISDatasetMapper
from vnext_tpu_torch.data.datasets import synthetic
from vnext_tpu_torch.data.datasets.ytvis import load_ytvis_json, register_ytvis_instances
from vnext_tpu_torch.structures.masks import polygons_to_bitmask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INSTANT = os.path.join(REPO, "configs", "quick_schedules", "idol_instant_test.yaml")
# a crop range that cuts the instant config's 128-pixel short side, so that crops are drawn
CROP = ["INPUT.CROP.ENABLED", "True", "INPUT.CROP.TYPE", "absolute_range", "INPUT.CROP.SIZE", "(80, 120)"]


def _cfgs(opts=()):
    """The instant config read by each package, with the same overrides."""
    out = []
    for get, add in ((jax_get_cfg, jax_add_idol_config), (get_cfg, add_idol_config)):
        cfg = get()
        add(cfg)
        cfg.merge_from_file(INSTANT)
        cfg.merge_from_list(list(opts))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The JAX generator's synthetic dataset (4 videos of 6 frames at 128x192)
    and its records as each package loads them."""
    root = str(tmp_path_factory.mktemp("ytvis"))
    json_file = jax_synthetic.generate_synthetic_ytvis(root, num_videos=4, num_frames=6)
    image_root = os.path.join(root, "JPEGImages")
    return json_file, jax_load_ytvis_json(json_file, image_root), load_ytvis_json(json_file, image_root)


def _assert_tree_equal(got, want, path="batch"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape, path
        assert np.array_equal(got, want), path
    else:
        assert got == want, path


# ---------------------------------------------------------------- catalogs and datasets
def test_catalogs_behave_as_jax():
    for mod in (catalog, jax_catalog):
        dc, mc = mod._DatasetCatalog(), mod._MetadataCatalog()
        dc.register("a", lambda: [{"x": 1}])
        assert "a" in dc and dc.list() == ["a"] and dc.get("a") == [{"x": 1}]
        with pytest.raises(ValueError, match="already registered"):
            dc.register("a", lambda: [])
        with pytest.raises(TypeError):
            dc.register("b", [1])
        with pytest.raises(KeyError, match="not registered"):
            dc.get("b")
        dc.remove("a")
        assert dc.list() == []
        meta = mc.get("a").set(thing_classes=["p"], json_file="f.json")
        assert mc.get("a") is meta and meta.get("json_file") == "f.json" and meta.get("nope", 3) == 3
        meta.thing_classes = ["p"]  # the same value is allowed
        with pytest.raises(AttributeError, match="cannot be overwritten"):
            meta.thing_classes = ["q"]
        assert meta.as_dict() == {"name": "a", "thing_classes": ["p"], "json_file": "f.json"}


def test_load_ytvis_json_records_equal_jax(tmp_path):
    """Category ids remapped to contiguous ones, invalid polygons filtered,
    frames where an instance is absent skipped, RLE segmentations kept."""
    rle = jax_rle_encode(np.eye(8, 12, dtype=bool))
    data = {
        "videos": [{"id": 7, "height": 8, "width": 12, "length": 3, "file_names": ["v/0.png", "v/1.png", "v/2.png"]},
                   {"id": 2, "height": 8, "width": 12, "length": 1, "file_names": ["w/0.png"]}],
        "annotations": [
            {"id": 1, "video_id": 7, "category_id": 20, "iscrowd": 0,
             "bboxes": [[1, 1, 4, 4], None, [2, 2, 3, 3]],
             "segmentations": [[[1, 1, 5, 1, 5, 5]], None, rle]},
            {"id": 2, "video_id": 7, "category_id": 5,
             "bboxes": [[0, 0, 2, 2], [0, 0, 2, 2], [0, 0, 2, 2]],
             "segmentations": [[[0, 0, 2, 0]], [[0, 0, 2, 0, 2, 2, 0, 2]], [[0, 0, 2, 0, 2, 2, 0]]]},
            {"id": 3, "video_id": 2, "category_id": 5, "bboxes": [[1, 2, 3, 4]],
             "segmentations": [[[1, 2, 4, 2, 4, 6, 1, 6]]]},
        ],
        "categories": [{"id": 20, "name": "b"}, {"id": 5, "name": "a"}],
    }
    path = tmp_path / "ann.json"
    path.write_text(json.dumps(data))
    want = jax_load_ytvis_json(str(path), "root", dataset_name="jax_crafted")
    got = load_ytvis_json(str(path), "root", dataset_name="port_crafted")
    assert got == want
    assert [r["video_id"] for r in got] == [2, 7]
    assert [len(f) for f in got[1]["annotations"]] == [1, 1, 1]     # id 2's two bad polygons filtered
    assert got[1]["annotations"][0][0]["category_id"] == 1        # 20 -> contiguous 1
    meta = catalog.MetadataCatalog.get("port_crafted")
    assert meta.thing_classes == ["a", "b"] and meta.thing_dataset_id_to_contiguous_id == {5: 0, 20: 1}


def test_synthetic_generator_writes_what_jax_writes(tmp_path):
    kwargs = dict(num_videos=3, num_frames=5, h=48, w=80, seed=11)
    want = jax_synthetic.generate_synthetic_ytvis(str(tmp_path / "jax"), **kwargs)
    got = synthetic.generate_synthetic_ytvis(str(tmp_path / "port"), **kwargs)
    with open(got) as f, open(want) as g:
        got_js, want_js = json.load(f), json.load(g)
    assert got_js == want_js and len(got_js["videos"]) == 3 and got_js["annotations"]
    for vid in got_js["videos"]:
        for name in vid["file_names"]:
            a = np.asarray(Image.open(tmp_path / "port" / "JPEGImages" / name))
            b = np.asarray(Image.open(tmp_path / "jax" / "JPEGImages" / name))
            assert a.shape == (48, 80, 3) and np.array_equal(a, b), name
    # a valid copy is not written again; another format version is
    assert synthetic._cache_valid(got)
    png = tmp_path / "port" / "JPEGImages" / got_js["videos"][0]["file_names"][0]
    mtime = png.stat().st_mtime_ns
    synthetic.generate_synthetic_ytvis(str(tmp_path / "port"), **kwargs)
    assert png.stat().st_mtime_ns == mtime
    (tmp_path / "stale.json").write_text(json.dumps({"info": {"synth_format": 1}}))
    assert not synthetic._cache_valid(str(tmp_path / "stale.json"))


def test_register_synthetic_ytvis_under_the_callers_root(tmp_path):
    name = "port_synthetic_under_tmp"
    synthetic.register_synthetic_ytvis(name, root=str(tmp_path), num_videos=1, num_frames=2)
    records = catalog.DatasetCatalog.get(name)
    meta = catalog.MetadataCatalog.get(name)
    assert meta.evaluator_type == "ytvis" and meta.thing_classes == synthetic.THING_CLASSES
    assert meta.json_file == str(tmp_path / "instances.json")
    assert len(records) == 1 and all(os.path.exists(p) for p in records[0]["file_names"])
    synthetic.register_synthetic_ytvis(name, root=str(tmp_path / "elsewhere"))   # registered: left alone
    assert not (tmp_path / "elsewhere").exists()


def test_polygons_to_bitmask_equals_jax():
    rng = np.random.RandomState(0)
    polys = [rng.rand(6) * [30, 20, 30, 20, 30, 20], np.asarray([2.5, 3.0, 20.5, 3.0, 20.5, 15.5, 2.5, 15.5]),
             np.asarray([1.0, 1.0, 3.0, 3.0])]                 # a 2-point polygon is skipped
    got = polygons_to_bitmask(polys, 20, 30)
    assert got.dtype == bool and got.any()
    assert np.array_equal(got, jax_polygons_to_bitmask(polys, 20, 30))
    assert not polygons_to_bitmask([], 4, 5).any()


# ---------------------------------------------------------------- transforms
@pytest.mark.parametrize("make", [
    lambda m: m.ResizeTransform(48, 80, 35, 61),
    lambda m: m.HFlipTransform(80),
    lambda m: m.CropTransform(7, 5, 50, 31),
    lambda m: m.NoOpTransform(),
    lambda m: m.TransformList([m.ResizeTransform(48, 80, 64, 107), m.CropTransform(3, 9, 90, 40),
                               m.HFlipTransform(90)]),
], ids=["resize", "hflip", "crop", "noop", "list"])
def test_transform_equals_jax(make):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (48, 80, 3)).astype(np.uint8)
    mask = (rng.rand(48, 80) > 0.6).astype(np.uint8) * 255
    boxes = np.asarray([[3.0, 4.0, 40.5, 30.0], [60.0, 1.0, 79.0, 47.0]])
    polys = [rng.rand(8) * 40]
    got, want = make(T), make(jax_T)
    for fn, arg in (("apply_image", img), ("apply_image", mask), ("apply_segmentation", mask),
                    ("apply_box", boxes), ("apply_coords", boxes.reshape(-1, 2))):
        a, b = getattr(got, fn)(arg.copy()), getattr(want, fn)(arg.copy())
        assert a.dtype == b.dtype and np.array_equal(a, b), fn
    for a, b in zip(got.apply_polygons(polys), want.apply_polygons(polys)):
        assert np.array_equal(a, b)
    try:
        jinv = want.inverse()
    except NotImplementedError:  # a crop is not invertible, in either package
        with pytest.raises(NotImplementedError, match="not invertible"):
            got.inverse()
        return
    inv = got.inverse()
    assert np.array_equal(inv.apply_coords(boxes.reshape(-1, 2)), jinv.apply_coords(boxes.reshape(-1, 2)))


@pytest.mark.parametrize("h, w, short, max_size", [(480, 853, 480, 1333), (720, 1280, 360, 600),
                                                   (853, 480, 320, 768), (128, 192, 128, 192)])
def test_resize_shortest_edge_equals_jax(h, w, short, max_size):
    got, want = T.get_resize_shortest_edge(h, w, short, max_size), jax_T.get_resize_shortest_edge(h, w, short, max_size)
    assert (got.new_h, got.new_w) == (want.new_h, want.new_w)


def test_clip_augmentation_draws_as_jax():
    """The same seeds draw the same short sides, crops and flips, and both
    crops and flips occur."""
    kinds = set()
    for seed in range(40):
        args = ((320, 352, 480, 640), 768, True, "absolute_range", (384, 600), True)
        got = T.ClipAugmentation(*args).build(480, 853, random.Random(seed))
        want = jax_T.ClipAugmentation(*args).build(480, 853, random.Random(seed))
        assert [type(t).__name__ for t in got.transforms] == [type(t).__name__ for t in want.transforms]
        for a, b in zip(got.transforms, want.transforms):
            assert vars(a) == vars(b)
        kinds.update(type(t).__name__ for t in got.transforms)
    assert kinds == {"ResizeTransform", "CropTransform", "HFlipTransform"}
    test = T.ClipAugmentation((480,), 1333, flip=False, is_train=False).build(480, 853, random.Random(0))
    assert [type(t).__name__ for t in test.transforms] == ["ResizeTransform"]


# ---------------------------------------------------------------- the mapper and the loaders
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
def test_mapper_equals_jax_bit_for_bit(dataset, is_train):
    _, jax_records, records = dataset
    jcfg, cfg = _cfgs(CROP)
    jmap, pmap = JaxMapper.from_config(jcfg, is_train=is_train), YTVISDatasetMapper.from_config(cfg, is_train=is_train)
    flips = crops = 0
    for seed in range(6):
        for i in range(len(records)):
            want = jmap(jax_records[i], random.Random(seed))
            got = pmap(records[i], random.Random(seed))
            _assert_tree_equal(got, want)
            tf = pmap.aug.build(records[i]["height"], records[i]["width"], random.Random(seed))
            names = [type(t).__name__ for t in tf.transforms]
            flips += "HFlipTransform" in names
            crops += "CropTransform" in names
    if is_train:
        assert flips and crops, "seeds that draw no flip or no crop test less"
        assert got["key"]["valid"].any() and got["key"]["masks_s4"].any()
    else:
        assert not flips and not crops


def test_mapper_decodes_rle_segmentations_as_jax(dataset):
    """RLE ground truth (the real datasets' format) goes through the mapper as
    polygons do."""
    _, jax_records, records = dataset
    jcfg, cfg = _cfgs(CROP)

    def as_rle(recs, encode):
        out = []
        for r in recs:
            r = dict(r, annotations=[[dict(o, segmentation=encode(jax_polygons_to_bitmask(
                [np.asarray(p) for p in o["segmentation"]], r["height"], r["width"]))) for o in frame]
                for frame in r["annotations"]])
            out.append(r)
        return out

    from vnext_tpu_torch.evaluation.rle import rle_encode

    jax_rle, port_rle = as_rle(jax_records, jax_rle_encode), as_rle(records, rle_encode)
    assert port_rle == jax_rle
    for seed in range(3):
        want = JaxMapper.from_config(jcfg)(jax_rle[0], random.Random(seed))
        got = YTVISDatasetMapper.from_config(cfg)(port_rle[0], random.Random(seed))
        _assert_tree_equal(got, want)
        polys = YTVISDatasetMapper.from_config(cfg)(records[0], random.Random(seed))
        _assert_tree_equal(got, polys)


def test_train_loader_first_batches_equal_jax(dataset):
    _, jax_records, records = dataset
    jcfg, cfg = _cfgs(CROP + ["SOLVER.IMS_PER_BATCH", "2"])
    want = jax_build.build_vis_train_loader(jcfg, dataset_dicts=jax_records, seed=5)
    got = build.build_vis_train_loader(cfg, dataset_dicts=records, seed=5)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a["key_image"].shape == (2, 128, 192, 3) and a["key_masks_s4"].shape == (2, 8, 32, 48)
        _assert_tree_equal(a, b)


def test_samplers_and_test_loader_equal_jax(dataset):
    _, jax_records, records = dataset
    it, jit = iter(build.TrainingSampler(5, seed=3)), iter(jax_build.TrainingSampler(5, seed=3))
    assert [next(it) for _ in range(17)] == [next(jit) for _ in range(17)]
    with pytest.raises(ValueError):
        build.TrainingSampler(0)
    assert list(build.InferenceSampler(7)) == list(jax_build.InferenceSampler(7)) == list(range(7))
    assert len(build.InferenceSampler(7)) == 7
    assert list(build.build_vis_test_loader(dataset_dicts=records)) == records
    name = "port_test_loader_records"
    register_ytvis_instances(name, {}, dataset[0], os.path.join(os.path.dirname(dataset[0]), "JPEGImages"))
    # registered, the loader remaps the categories to contiguous ids: the videos and frames are the same
    loaded = list(build.build_vis_test_loader(dataset_name=name))
    assert [(r["video_id"], r["file_names"]) for r in loaded] == [(r["video_id"], r["file_names"]) for r in records]


def test_prefetch_raises_the_threads_error_at_next():
    """The JAX package's iterator would end with StopIteration here."""
    def mapper(record, rng):
        if record["n"] == 2:
            raise OSError("unreadable frame")
        return {f: {k: np.zeros(1) for k in ("image", "size", "labels", "boxes", "masks_s4", "valid", "inst_id")}
                for f in ("key", "ref")}

    loader = build.build_vis_train_loader(dataset_dicts=[{"n": i} for i in range(4)], mapper=mapper,
                                          batch_size=1, seed=0)
    with pytest.raises(OSError, match="unreadable frame"):
        for _ in range(20):
            next(loader)
    with pytest.raises(OSError, match="unreadable frame"):
        next(loader)
    finite = build.PrefetchIterator(iter([1, 2]))
    assert list(finite) == [1, 2]
    with pytest.raises(StopIteration):
        next(finite)
