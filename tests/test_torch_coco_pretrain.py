"""IDOL's COCO-pretrain data layer, the samplers, PreciseBN, the profiler hook
and the ``.pkl`` importer of the port against the JAX package's, on the CPU.

The host pipeline is numpy, PIL, ``random.Random`` and ``RandomState`` in both
packages, so records, files, index streams, mapped arrays and imported weights
are held equal bit for bit (no tolerance):

- ``load_coco_json``: records and metadata on a json with sparse category ids,
  a crowd RLE, polygons too short or of odd length, and integer and float
  keypoints; ``register_all_coco`` reads ``VNEXT_DATASETS``;
- the synthetic COCO generator: the json and every PNG byte-equal;
- ``CocoClipDatasetMapper`` at the COCO-pretrain yaml's settings (512x640
  target, crop 384-600 half the time, flip) on the synthetic images with a
  crowd object and a small object in a corner added: seeds 0-5, with and
  without ``INPUT.PRETRAIN_SAME_CROP``; some draw crops the corner object away,
  which must stay invalid with ``inst_id`` -1;
- ``TrainingSampler`` over several epochs, ``RepeatFactorTrainingSampler``
  (image and video records) and ``AspectRatioGroupedDataset``: the first
  indices and batches;
- ``make_synthetic_videos`` and its image loader;
- ``.pkl`` files written from seeded numpy for a ResNet-18 (a torchvision-form
  ``{"model", "__author__"}`` pickle and Caffe2 blob dicts, flat and under
  ``"blobs"``, with ``_momentum`` blobs and folded BNs): the same names and
  arrays through both loaders, and the same tensors in a port backbone.

Where the arithmetic differs the tolerance is stated: PreciseBN's statistics
on a tiny Conv-BN-ReLU-Conv-BN model (JAX recovers each batch's statistics
from flax's ``new = m old + (1 - m) batch`` at m = 0.9, which scales f32
rounding of values near 1 by 1 / (1 - m) = 10, and flax's variance is
E[x^2] - E[x]^2; the port reads them directly), rtol 1e-5 / atol 1e-5.
``ProfilerHook`` writes one trace for its window, or after training when the
run ends inside it.
"""

import json
import os
import pickle
import random
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from vnext_tpu.checkpoint import torch_import as jax_import
from vnext_tpu.config import add_idol_config as jax_add_idol_config
from vnext_tpu.config import get_cfg as jax_get_cfg
from vnext_tpu.data import build as jax_build
from vnext_tpu.data import catalog as jax_catalog
from vnext_tpu.data import synthetic as jax_videos
from vnext_tpu.data.coco_clip_mapper import CocoClipDatasetMapper as JaxCocoMapper
from vnext_tpu.data.datasets import coco as jax_coco
from vnext_tpu.data.datasets import synthetic as jax_synthetic
from vnext_tpu.engine.hooks import update_bn_stats as jax_update_bn_stats
from vnext_tpu_torch.checkpoint import torch_import
from vnext_tpu_torch.checkpoint.checkpointer import load_weights
from vnext_tpu_torch.config import add_idol_config, get_cfg
from vnext_tpu_torch.data import build, catalog
from vnext_tpu_torch.data import synthetic as videos
from vnext_tpu_torch.data.coco_clip_mapper import CocoClipDatasetMapper
from vnext_tpu_torch.data.datasets import coco, synthetic
from vnext_tpu_torch.engine.hooks import PreciseBNHook, ProfilerHook, update_bn_stats
from vnext_tpu_torch.models.backbones.resnet import ResNet
from vnext_tpu_torch.models.layers import init_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAIN = os.path.join(REPO, "configs", "idol", "coco_pretrain", "r50_coco_sequence.yaml")
BB = "detr.detr.backbone.0.backbone."


def _assert_equal_trees(got, want, path="root"):
    assert type(got) is type(want) or (isinstance(got, (int, float)) and isinstance(want, (int, float))), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_equal_trees(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_equal_trees(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want), path
    else:
        assert got == want, path


# ---------------------------------------------------------------- datasets
def _coco_json(path):
    data = {
        "images": [{"id": 7, "file_name": "b.png", "height": 20, "width": 30},
                   {"id": 3, "file_name": "a.png", "height": 20, "width": 30}],
        "categories": [{"id": 90, "name": "toothbrush"}, {"id": 1, "name": "person"}, {"id": 5, "name": "plane"}],
        "annotations": [
            {"id": 1, "image_id": 3, "category_id": 5, "bbox": [1, 2, 10, 8], "iscrowd": 0,
             "segmentation": [[1, 2, 11, 2, 11, 10, 1, 10], [1, 2, 3]]},
            {"id": 2, "image_id": 3, "category_id": 90, "bbox": [0, 0, 5, 5], "iscrowd": 0,
             "segmentation": [[0, 0, 5, 0]]},
            {"id": 3, "image_id": 7, "category_id": 1, "bbox": [2, 2, 4, 4], "iscrowd": 1,
             "segmentation": {"size": [20, 30], "counts": [44, 4, 16, 4, 532]}},
            {"id": 4, "image_id": 7, "category_id": 1, "bbox": [3, 3, 9, 9], "iscrowd": 0,
             "segmentation": [[3, 3, 12, 3, 12, 12, 3, 12]],
             "keypoints": [4, 5, 2, 6.5, 7, 1, 0, 0, 0]},
        ],
    }
    with open(path, "w") as f:
        json.dump(data, f)


def test_load_coco_json_records_equal_jax(tmp_path):
    _coco_json(tmp_path / "coco.json")
    got = coco.load_coco_json(str(tmp_path / "coco.json"), "img", dataset_name="port_coco_json")
    want = jax_coco.load_coco_json(str(tmp_path / "coco.json"), "img", dataset_name="port_coco_json")
    _assert_equal_trees(got, want)
    assert [r["image_id"] for r in got] == [3, 7] and len(got[0]["annotations"]) == 1
    assert got[1]["annotations"][1]["keypoints"] == [4.5, 5.5, 2, 6.5, 7.5, 1, 0.5, 0.5, 0]
    meta, jmeta = catalog.MetadataCatalog.get("port_coco_json"), jax_catalog.MetadataCatalog.get("port_coco_json")
    assert meta.thing_classes == jmeta.thing_classes == ["person", "plane", "toothbrush"]
    assert meta.thing_dataset_id_to_contiguous_id == jmeta.thing_dataset_id_to_contiguous_id == {1: 0, 5: 1, 90: 2}
    _assert_equal_trees(coco.load_coco_json(str(tmp_path / "coco.json"), "img"),
                        jax_coco.load_coco_json(str(tmp_path / "coco.json"), "img"))


def test_register_all_coco_reads_vnext_datasets(tmp_path, monkeypatch):
    monkeypatch.setenv("VNEXT_DATASETS", str(tmp_path))
    for module, cat in ((coco, catalog), (jax_coco, jax_catalog)):
        monkeypatch.setattr(module, "DatasetCatalog", type(cat.DatasetCatalog)())
        monkeypatch.setattr(module, "MetadataCatalog", type(cat.MetadataCatalog)())
    coco.register_all_coco()
    jax_coco.register_all_coco()
    names = ["coco_2017_train", "coco_2017_val", "keypoints_coco_2017_train", "keypoints_coco_2017_val"]
    assert sorted(coco.DatasetCatalog.list()) == sorted(jax_coco.DatasetCatalog.list()) == sorted(names)
    for name in names:
        meta, jmeta = coco.MetadataCatalog.get(name).as_dict(), vars(jax_coco.MetadataCatalog.get(name))
        assert meta == jmeta, name
    assert coco.MetadataCatalog.get("coco_2017_val").json_file == str(
        tmp_path / "coco" / "annotations" / "instances_val2017.json")
    assert coco.MetadataCatalog.get("keypoints_coco_2017_val").keypoint_flip_indices[:3] == [0, 2, 1]


def test_synthetic_coco_files_equal_jax(tmp_path):
    got = synthetic.generate_synthetic_coco(str(tmp_path / "port"), num_images=3, h=40, w=56, seed=4)
    want = jax_synthetic.generate_synthetic_coco(str(tmp_path / "jax"), num_images=3, h=40, w=56, seed=4)
    assert open(got, "rb").read() == open(want, "rb").read()
    names = sorted(os.listdir(tmp_path / "jax" / "images"))
    assert names == sorted(os.listdir(tmp_path / "port" / "images")) and len(names) == 3
    for n in names:
        assert (tmp_path / "port" / "images" / n).read_bytes() == (tmp_path / "jax" / "images" / n).read_bytes(), n


@pytest.fixture(scope="module")
def coco_records(tmp_path_factory):
    """The synthetic COCO images (8 at 160x224) as port records, each with a crowd
    polygon and a 6x6 object in the bottom-right corner added."""
    root = tmp_path_factory.mktemp("synth_coco")
    json_file = synthetic.generate_synthetic_coco(str(root))
    records = coco.load_coco_json(json_file, str(root / "images"))
    for rec in records:
        rec["annotations"] += [
            {"iscrowd": 1, "id": 900, "category_id": 0, "bbox": [10, 10, 30, 20],
             "segmentation": [[10, 10, 40, 10, 40, 30, 10, 30]]},
            {"iscrowd": 0, "id": 901, "category_id": 2, "bbox": [216, 152, 6, 6],
             "segmentation": [[216, 152, 222, 152, 222, 158, 216, 158]]},
        ]
    return records


def _cfgs(*opts):
    cfgs = []
    for get, add in ((get_cfg, add_idol_config), (jax_get_cfg, jax_add_idol_config)):
        cfg = get()
        add(cfg)
        cfg.merge_from_file(PRETRAIN)
        cfg.merge_from_list(list(opts))
        cfgs.append(cfg)
    return cfgs


def _xyxy(frame):
    """The valid slots' boxes in pixels of the frame's size (from normalized cxcywh)."""
    h, w = frame["size"].astype(np.float64)
    cx, cy, bw, bh = frame["boxes"].astype(np.float64).T
    return np.stack([(cx - bw / 2) * w, (cy - bh / 2) * h, (cx + bw / 2) * w, (cy + bh / 2) * h], 1)


def _check_cut(got, big, th=512, tw=640):
    """A frame the JAX mapper cannot make at 512x640 (its image is cut to the
    target, its masks are not: a broadcast error) against JAX's frame of the
    same draw at a target that holds it: the image and the masks cut to
    512x640, the size, the labels and ids equal; the boxes are the big frame's
    clipped to the cut (to 1e-3 pixel: both are f32 fractions of ~600 pixels);
    an instance the cut empties is invalid."""
    assert np.array_equal(got["image"], big["image"][:th, :tw])
    assert np.array_equal(got["size"], np.minimum(big["size"], [th, tw]))
    s = 4
    assert (got["valid"] <= big["valid"]).all()
    box, big_box = _xyxy(got), _xyxy(big)
    big_box[:, 0::2] = big_box[:, 0::2].clip(0, got["size"][1])
    big_box[:, 1::2] = big_box[:, 1::2].clip(0, got["size"][0])
    for slot in np.flatnonzero(big["valid"]):
        cut = big["masks_s4"][slot][: th // s, : tw // s]
        if got["valid"][slot]:
            assert np.array_equal(got["masks_s4"][slot], cut), slot
            assert got["labels"][slot] == big["labels"][slot] and got["inst_id"][slot] == big["inst_id"][slot]
            np.testing.assert_allclose(box[slot], big_box[slot], rtol=0, atol=1e-3)
        else:
            empty = big_box[slot, 2] - big_box[slot, 0] <= 1e-3 or big_box[slot, 3] - big_box[slot, 1] <= 1e-3
            assert empty or not cut.any(), slot
            assert not got["masks_s4"][slot].any() and got["inst_id"][slot] == -1


@pytest.mark.parametrize("same_crop", [False, True])
def test_coco_clip_mapper_equals_jax_bit_for_bit(coco_records, same_crop):
    """Where JAX's mapper runs, bit for bit; where it raises (a draw larger than
    512x640), against JAX's frame at 768x768 cut to 512x640 (``_check_cut``)."""
    opts = ("INPUT.PRETRAIN_SAME_CROP", str(same_crop))
    cfg, jcfg = _cfgs(*opts)
    _, jbig = _cfgs(*opts, "TPU.TRAIN_IMAGE_SIZE", "[768, 768]")
    mapper, jmapper, jmapper_big = (CocoClipDatasetMapper.from_config(cfg), JaxCocoMapper.from_config(jcfg),
                                    JaxCocoMapper.from_config(jbig))
    cropped_away, kinds = 0, set()
    for seed in range(6):
        rec = coco_records[seed]
        got = mapper(rec, random.Random(seed))
        try:
            want = jmapper(rec, random.Random(seed))
        except ValueError as e:
            assert "could not broadcast" in str(e)
            big = jmapper_big(rec, random.Random(seed))
            for frame in ("key", "ref"):
                _check_cut(got[frame], big[frame])
            kinds.add("cut")
        else:
            _assert_equal_trees(got, want, f"seed {seed}")
            kinds.add("equal")
        n = len(rec["annotations"])
        for frame in ("key", "ref"):
            assert got[frame]["image"].shape == (512, 640, 3) and got[frame]["masks_s4"].shape[1:] == (128, 160)
            assert not got[frame]["valid"][n - 2] and got[frame]["inst_id"][n - 2] == -1   # the crowd object
        assert (got["ref"]["valid"] <= got["key"]["valid"]).all()
        if same_crop:
            assert np.array_equal(got["key"]["image"], got["ref"]["image"])
        cropped_away += int(not got["key"]["valid"][n - 1])
        valid = got["key"]["valid"]
        assert (got["key"]["inst_id"][valid] == np.flatnonzero(valid) + 1).all()
    assert cropped_away > 0, "no draw cropped the corner object away"
    assert kinds == {"equal", "cut"}, kinds


@pytest.mark.parametrize("seed", [0, 3])
def test_coco_loader_batches_equal_jax(coco_records, seed):
    cfg, jcfg = _cfgs("TPU.TRAIN_IMAGE_SIZE", "[768, 768]")   # every draw fits: JAX's mapper runs
    got = build.build_vis_train_loader(cfg, mapper=CocoClipDatasetMapper.from_config(cfg),
                                       dataset_dicts=coco_records, batch_size=2, seed=seed)
    want = jax_build.build_vis_train_loader(jcfg, mapper=JaxCocoMapper.from_config(jcfg),
                                            dataset_dicts=coco_records, batch_size=2, seed=seed)
    for step in range(2):
        _assert_equal_trees(next(got), next(want), f"batch {step}")


# ---------------------------------------------------------------- samplers
def _take(it, n):
    it = iter(it)
    return [next(it) for _ in range(n)]


def test_training_sampler_epochs_equal_jax():
    got = _take(build.TrainingSampler(5, seed=3), 15)
    assert got == _take(jax_build.TrainingSampler(5, seed=3), 15)
    epochs = [got[i:i + 5] for i in (0, 5, 10)]
    assert all(sorted(e) == list(range(5)) for e in epochs) and len({tuple(e) for e in epochs}) > 1
    assert _take(build.TrainingSampler(5, seed=4), 15) == _take(jax_build.TrainingSampler(5, seed=4), 15) != got


@pytest.mark.parametrize("kind", ["images", "videos"])
def test_repeat_factor_sampler_equals_jax(kind):
    rng = np.random.RandomState(7)
    if kind == "images":
        dicts = [{"annotations": [{"category_id": int(c)} for c in rng.choice(6, rng.randint(0, 3), p=[.5, .2, .1, .1, .05, .05])]}
                 for _ in range(30)]
    else:
        dicts = [{"annotations": [[{"category_id": int(c)} for c in rng.choice(5, rng.randint(0, 3))]
                                  for _ in range(3)]} for _ in range(12)]
    got = build.RepeatFactorTrainingSampler(dicts, 0.3, seed=2)
    want = jax_build.RepeatFactorTrainingSampler(dicts, 0.3, seed=2)
    assert np.array_equal(got._repeat_factors, want._repeat_factors) and got._repeat_factors.max() > 1
    assert _take(got, 150) == _take(want, 150)


def test_aspect_ratio_grouping_equals_jax():
    rng = np.random.RandomState(8)
    samples = [{"height": int(h), "width": int(w), "i": i} for i, (h, w) in enumerate(rng.randint(10, 40, (25, 2)))]
    got = list(build.AspectRatioGroupedDataset(iter(samples), 3))
    assert got == list(jax_build.AspectRatioGroupedDataset(iter(samples), 3))
    assert all(len({s["width"] > s["height"] for s in b}) == 1 for b in got) and len(got) >= 6
    key = lambda s: s["i"] % 2  # noqa: E731
    assert list(build.AspectRatioGroupedDataset(samples, 4, key)) == list(
        jax_build.AspectRatioGroupedDataset(samples, 4, key))


def test_synthetic_videos_equal_jax():
    got, store = videos.make_synthetic_videos(num_videos=3, length=4, height=48, width=64, num_classes=5, seed=2)
    want, jstore = jax_videos.make_synthetic_videos(num_videos=3, length=4, height=48, width=64, num_classes=5, seed=2)
    _assert_equal_trees(got, want)
    _assert_equal_trees(store, jstore)
    name = got[1]["file_names"][2]
    assert videos.make_image_loader(store)(name) is store[name]


# ---------------------------------------------------------------- PreciseBN and the profiler
class _JaxNet(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool):
        x = fnn.Conv(4, (3, 3))(x)
        x = fnn.BatchNorm(use_running_average=not train, momentum=0.9)(x)
        x = fnn.Conv(5, (3, 3))(fnn.relu(x))
        return fnn.BatchNorm(use_running_average=not train, momentum=0.9)(x)


def _torch_net(params):
    net = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1), nn.BatchNorm2d(4), nn.ReLU(), nn.Conv2d(4, 5, 3, padding=1),
                        nn.BatchNorm2d(5))
    with torch.no_grad():
        for conv, bn, name in ((net[0], net[1], "0"), (net[3], net[4], "1")):
            conv.weight.copy_(torch.from_numpy(np.asarray(params[f"Conv_{name}"]["kernel"]).transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.from_numpy(np.asarray(params[f"Conv_{name}"]["bias"])))
            bn.weight.copy_(torch.from_numpy(np.asarray(params[f"BatchNorm_{name}"]["scale"])))
            bn.bias.copy_(torch.from_numpy(np.asarray(params[f"BatchNorm_{name}"]["bias"])))
    return net


@pytest.fixture(scope="module")
def bn_case():
    rng = np.random.RandomState(9)
    batches = [(rng.randn(2, 8, 8, 3) * 2 + 0.5).astype(np.float32) for _ in range(3)]
    model = _JaxNet()
    variables = jax.tree.map(np.asarray, jax.jit(model.init, static_argnums=2)(jax.random.PRNGKey(0),
                                                                                jnp.asarray(batches[0]), False))
    params = jax.tree.map(lambda p: (p + 0.3 * rng.randn(*p.shape)).astype(np.float32), variables["params"])
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    apply = jax.jit(lambda v, b: model.apply(v, b, True, mutable=["batch_stats"])[1]["batch_stats"])
    want = jax_update_bn_stats(apply, variables, [jnp.asarray(b) for b in batches], momentum=0.9)
    return batches, params, jax.tree.map(np.asarray, want)


def _torch_batches(batches):
    return [torch.from_numpy(b.transpose(0, 3, 1, 2).copy()) for b in batches]


def test_update_bn_stats_equals_jax(bn_case):
    batches, params, want = bn_case
    net = _torch_net(params).eval()
    assert update_bn_stats(net, _torch_batches(batches)) == 3
    assert not net.training and all(int(m.num_batches_tracked) == 0 for m in (net[1], net[4]))
    for bn, name in ((net[1], "BatchNorm_0"), (net[4], "BatchNorm_1")):
        np.testing.assert_allclose(bn.running_mean.numpy(), want[name]["mean"], rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(bn.running_var.numpy(), want[name]["var"], rtol=1e-5, atol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="at least one batch"):
        update_bn_stats(net, [])


def test_precise_bn_hook_refreshes_the_trainers_model(bn_case):
    batches, params, _ = bn_case
    net, ref = _torch_net(params), _torch_net(params)
    update_bn_stats(ref, _torch_batches(batches[:2]))
    hook = PreciseBNHook(_torch_batches(batches), num_iters=2, period=3)
    hook.trainer = types.SimpleNamespace(state=types.SimpleNamespace(model=net), iter=0)
    hook.after_step()                                   # step 0: not a period's end
    assert torch.equal(net[1].running_var, torch.ones(4))
    hook.trainer.iter = 2
    hook.after_step()
    for a, b in ((net[1], ref[1]), (net[4], ref[4])):
        assert torch.equal(a.running_mean, b.running_mean) and torch.equal(a.running_var, b.running_var)
    hook.trainer.state.model = nn.Linear(2, 2)          # no BatchNorm: left alone
    hook.after_train()


@pytest.mark.parametrize("start, steps, run", [(2, 2, 6), (4, 5, 6)], ids=["window", "ends_inside"])
def test_profiler_hook_writes_one_trace_for_its_window(tmp_path, start, steps, run):
    hook = ProfilerHook(str(tmp_path), start_iter=start, num_steps=steps)
    hook.trainer = types.SimpleNamespace(iter=0)
    x = torch.ones(8, 8)
    for it in range(run):
        hook.trainer.iter = it
        hook.before_step()
        x = torch.tanh(x @ x)
        hook.after_step()
    hook.after_train()
    assert os.listdir(tmp_path) == [f"trace_{start}.json"]
    events = json.loads((tmp_path / f"trace_{start}.json").read_text())["traceEvents"]
    assert any("tanh" in e.get("name", "") for e in events)


# ---------------------------------------------------------------- the .pkl importer
@pytest.fixture(scope="module")
def resnet18_d2():
    """A seeded ResNet-18's state under detectron2 names (numpy)."""
    wrapper = nn.Module()
    wrapper.backbone = ResNet(depth=18)
    init_weights(wrapper, seed=11)
    ref = torch_import.to_reference_names(wrapper.state_dict(), "idol")
    return {k[len(BB):]: v.numpy().copy() for k, v in ref.items()}


def _c2_name(d2):
    """The Caffe2 blob name of a detectron2 ResNet name."""
    parts = d2.split(".")
    leaf = {"weight": "s", "bias": "b"}[parts[-1]] if "norm" in parts else {"weight": "w", "bias": "b"}[parts[-1]]
    if parts[0] == "stem":
        return "res_conv1_bn_" + leaf if "norm" in parts else "conv1_" + leaf
    branch = {"conv1": "branch2a", "conv2": "branch2b", "conv3": "branch2c", "shortcut": "branch1"}[parts[2]]
    return f"{parts[0]}_{parts[1]}_{branch}" + ("_bn_" if "norm" in parts else "_") + leaf


def _write_pkls(tmp_path, d2):
    torchvision = {"model": d2, "__author__": "torchvision", "matching_heuristics": True}
    # Caffe2's BNs are folded: scale and bias only, no running statistics
    blobs = {_c2_name(k): v for k, v in d2.items() if not k.endswith(("running_mean", "running_var"))}
    blobs.update({"conv1_w_momentum": np.zeros(3, np.float32), "fc1000_w": np.ones((2, 2), np.float32)})
    paths = {}
    for name, obj in (("torchvision", torchvision), ("caffe2_flat", blobs), ("caffe2_blobs", {"blobs": blobs})):
        paths[name] = str(tmp_path / f"{name}.pkl")
        with open(paths[name], "wb") as f:
            pickle.dump(obj, f)
    return paths


def test_pkl_files_load_as_jax_loads_them(tmp_path, resnet18_d2):
    paths = _write_pkls(tmp_path, resnet18_d2)
    for name, path in paths.items():
        got, want = torch_import.load_torch_state_dict(path), jax_import.load_torch_state_dict(path)
        assert set(got) == set(want), name
        for k in want:
            assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), want[k]), (name, k)
        assert torch_import.detect_checkpoint_family(got) == jax_import.detect_checkpoint_family(want) == "d2_backbone"
        for k, v in resnet18_d2.items():    # Caffe2's folded BNs come back as identity statistics
            expect = (np.zeros_like(v) if k.endswith("running_mean") else np.ones_like(v)) if (
                name != "torchvision" and k.endswith(("running_mean", "running_var"))) else v
            assert np.array_equal(got[k].numpy(), expect), (name, k)
    c2 = {_c2_name(k): v for k, v in resnet18_d2.items() if not k.endswith(("running_mean", "running_var"))}
    _assert_equal_trees(torch_import.convert_c2_names(c2), jax_import.convert_c2_names(c2))


def test_pkl_backbone_loads_into_the_port(tmp_path, resnet18_d2):
    paths = _write_pkls(tmp_path, resnet18_d2)
    for name, path in paths.items():
        model = nn.Module()
        model.backbone = ResNet(depth=18)
        init_weights(model, seed=1)
        load_weights(path, model)
        want = torch_import.load_torch_state_dict(path)
        own = model.state_dict()
        ref = torch_import.to_reference_names(own, "idol")
        assert len(ref) == len(own) == 100
        for k, v in ref.items():
            assert torch.equal(v, want[k[len(BB):]]), (name, k)
