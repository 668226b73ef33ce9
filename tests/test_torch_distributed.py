"""The port's distribution (``parallel/``, ``engine/launch.py``, DDP in the train
step, the global loss counts, the sharded samplers and the gathering
evaluators) on two CPU processes of a gloo group, against the JAX package and
against one process.

One pair of processes (tests/_torch_dist_worker.py, started through the port's
``launch`` as two machines of one process, as tests/test_distributed_launch.py
starts JAX's) computes everything and writes it to files; the module fixture
makes their inputs, starts them, computes the JAX and one-process references
while they run, and reads the files. Each check is its own case:

- the tiny IDOL's two-rank step (one clip a rank, 3 and 1 instances: the
  global counts are what makes the ranks' mean gradient the whole batch's)
  reports JAX's one-device step's losses on the two clips at
  tests/test_spmd.py's rtol 2e-4 / atol 2e-5; its parameters after the step
  equal the port's one-process step's, and a second step runs (DDP finds no
  parameter without a gradient);
- a tiny RetinaNet's two-rank step (3 and 1 objects: foreground counts that
  differ by rank) equals the port's one-process step;
- ``infer_tp_specs`` selects JAX's parameters (by the bridge's names), and
  ``apply_tp`` on a model axis of 2 gives the replicated losses;
- two-rank time-sharded inference equals one process' ``IDOL.inference``;
- each of the nine evaluators, fed half the images (videos) on each rank,
  returns on rank 0 what one process returns on all of them, and None on rank 1;
- two-rank ``SyncBatchNorm`` equals JAX's under ``shard_map`` over 2 host
  devices on the concatenated batch: outputs and running statistics;
- rank 1 writes ``log.txt.rank1``;
- the samplers' shards and the loaders' batches at ``shard_index`` 0 and 1
  are JAX's, bit for bit (in this process).
"""

import copy
import math
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vnext_tpu.data import build as jax_build
from vnext_tpu.data.datasets.synthetic import generate_synthetic_ytvis as jax_generate_synthetic_ytvis
from vnext_tpu.data.datasets.ytvis import load_ytvis_json as jax_load_ytvis_json
from vnext_tpu.engine.trainer import batch_to_model_inputs as jax_inputs
from vnext_tpu.models import layers as jax_layers
from vnext_tpu.models.criterion import default_weight_dict as jax_weight_dict
from vnext_tpu.models.idol import IDOL as JaxIDOL
from vnext_tpu.parallel import infer_tp_specs as jax_infer_tp_specs
from vnext_tpu_torch.checkpoint.from_jax import params_from_jax
from vnext_tpu_torch.data import build
from vnext_tpu_torch.data.datasets.ytvis import load_ytvis_json
from vnext_tpu_torch.engine.launch import launch
from vnext_tpu_torch.engine.train_step import TrainState, make_train_step
from vnext_tpu_torch.engine.trainer import PIXEL_MEAN, PIXEL_STD, batch_to_model_inputs
from vnext_tpu_torch.models.criterion import default_weight_dict
from vnext_tpu_torch.models.idol import IDOL
from vnext_tpu_torch.models.layers import init_weights
from vnext_tpu_torch.models.rcnn import DetTargets
from vnext_tpu_torch.models.retinanet import RetinaNet
from vnext_tpu_torch.solver import build as solver

from _tiny_idol import NQ
from _torch_helpers import TINY_IDOL, random_params, tiny_batch, ytvis19_r50_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
IDOL_CONFIG = os.path.join(REPO, "configs", "idol", "ytvis19_r50.yaml")
TINY = dict(max_insts=8, dropout=0.0)
RETINA = dict(num_classes=4, backbone_depth=18, fpn_channels=32, test_score_thresh=0.5)
# tests/test_spmd.py's tolerance for a sharded step against one device
RTOL, ATOL = 2e-4, 2e-5
# the same framework on both sides: sums in other orders (the ranks' partial sums, then their mean)
TOL_SAME = 1e-5
# the evaluators' floating sums, added per rank and then across ranks
TOL_EVAL = 1e-9


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------- the evaluators' inputs
def _detections(rng, boxes, classes, n_classes, h, w, n_extra=3):
    """Outputs near the ground truth (jittered, some relabelled) and random
    extra boxes, with the boxes' masks."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    near = boxes + rng.uniform(-3, 3, boxes.shape)
    cls = np.asarray(classes, np.int64).copy()
    flip = rng.rand(len(cls)) < 0.25
    cls[flip] = rng.randint(n_classes, size=int(flip.sum()))
    x0, y0 = rng.uniform(0, w - 8, n_extra), rng.uniform(0, h - 8, n_extra)
    extra = np.stack([x0, y0, x0 + rng.uniform(4, w / 2, n_extra), y0 + rng.uniform(4, h / 2, n_extra)], 1)
    out_boxes = np.clip(np.concatenate([near, extra]), 0, [w, h, w, h])
    masks = np.zeros((len(out_boxes), h, w), bool)
    for i, (a, b, c, d) in enumerate(np.round(out_boxes).astype(int)):
        masks[i, b:d, a:c] = True
    return {"boxes": out_boxes.astype(np.float32), "scores": rng.rand(len(out_boxes)).astype(np.float32),
            "classes": np.concatenate([cls, rng.randint(n_classes, size=n_extra)]),
            "valid": rng.rand(len(out_boxes)) < 0.9, "masks": masks}


def _xyxy(a):
    x, y, w, h = a["bbox"]
    return [x, y, x + w, y + h]


def _evaluator_inputs(root):
    """(name, evaluator after reset, records, outputs) for each of the nine evaluators."""
    from vnext_tpu_torch.data.catalog import MetadataCatalog
    from vnext_tpu_torch.data.datasets import cityscapes, coco, lvis, pascal_voc, synthetic
    from vnext_tpu_torch.evaluation.cityscapes_eval import CityscapesInstanceEvaluator, CityscapesSemSegEvaluator
    from vnext_tpu_torch.evaluation.coco_eval import COCOEvaluator
    from vnext_tpu_torch.evaluation.lvis_eval import LVISEvaluator
    from vnext_tpu_torch.evaluation.panoptic_eval import COCOPanopticEvaluator
    from vnext_tpu_torch.evaluation.pascal_voc_eval import PascalVOCDetectionEvaluator
    from vnext_tpu_torch.evaluation.rotated_coco_eval import RotatedCOCOEvaluator
    from vnext_tpu_torch.evaluation.sem_seg_eval import SemSegEvaluator
    from vnext_tpu_torch.evaluation.ytvis_eval import YTVISEvaluator
    from vnext_tpu_torch.structures.masks import polygons_to_bitmask

    rng = np.random.RandomState(20)
    out = []
    # COCO
    json_file = synthetic.generate_synthetic_coco(os.path.join(root, "coco"), num_images=4, h=64, w=96, seed=21)
    records = coco.load_coco_json(json_file, os.path.join(root, "coco", "images"))
    MetadataCatalog.get("dist_coco").set(json_file=json_file)
    outputs = [_detections(rng, [_xyxy(a) for a in r["annotations"]], [a["category_id"] for a in r["annotations"]],
                           3, r["height"], r["width"]) for r in records]
    out.append(("coco", COCOEvaluator("dist_coco", ("bbox", "segm")), records, outputs))
    # LVIS
    paths = synthetic.generate_synthetic_lvis(os.path.join(root, "lvis"), num_train=1, num_val=4, h=64, w=96, seed=22)
    records = lvis.load_lvis_json(paths["lvis_v1_val"], os.path.join(root, "lvis", "coco"))
    MetadataCatalog.get("dist_lvis").set(json_file=paths["lvis_v1_val"],
                                         thing_dataset_id_to_contiguous_id={i + 1: i for i in range(1203)})
    outputs = [_detections(rng, [_xyxy(a) for a in r["annotations"]], [a["category_id"] - 1 for a in r["annotations"]],
                           1203, r["height"], r["width"]) for r in records]
    out.append(("lvis", LVISEvaluator("dist_lvis", tasks=("bbox", "segm")), records, outputs))
    # Pascal VOC
    synthetic.generate_synthetic_voc(os.path.join(root, "voc"), num_train=1, num_val=1, num_test=4, h=60, w=80, seed=23)
    records = pascal_voc.load_voc_instances(os.path.join(root, "voc", "VOC2007"), "test")
    outputs = [_detections(rng, [a["bbox"] for a in r["annotations"]], [a["category_id"] for a in r["annotations"]],
                           20, r["height"], r["width"]) for r in records]
    out.append(("pascal_voc", PascalVOCDetectionEvaluator(list(pascal_voc.CLASS_NAMES)), records, outputs))
    # Cityscapes, instance and semantic
    synthetic.generate_synthetic_cityscapes(os.path.join(root, "cs"), num_train=1, num_val=4, h=48, w=96, seed=24)
    dirs = (os.path.join(root, "cs", "cityscapes", "leftImg8bit", "val"),
            os.path.join(root, "cs", "cityscapes", "gtFine", "val"))
    records = cityscapes.load_cityscapes_instances(*dirs)
    outputs = [_detections(rng, [a["bbox"] for a in r["annotations"]], [a["category_id"] for a in r["annotations"]],
                           8, r["height"], r["width"]) for r in records]
    names = [n for n, _ in cityscapes.CITYSCAPES_THING_CLASSES]
    out.append(("cityscapes_instance", CityscapesInstanceEvaluator(class_names=names), records, outputs))
    sizes = [(r["height"], r["width"]) for r in records]
    records = cityscapes.load_cityscapes_semantic(*dirs)
    outputs = [{"sem_seg": rng.randint(19, size=hw)} for hw in sizes]
    out.append(("cityscapes_sem_seg", CityscapesSemSegEvaluator(), records, outputs))
    # semantic segmentation
    records, outputs = [], []
    for _ in range(4):
        gt = rng.randint(0, 4, (20, 30))
        gt[rng.rand(20, 30) < 0.2] = 255
        records.append({"sem_seg_gt": gt})
        outputs.append({"sem_seg": np.where(rng.rand(20, 30) < 0.6, gt, rng.randint(0, 5, (20, 30)))})
    out.append(("sem_seg", SemSegEvaluator(5), records, outputs))
    # panoptic: each image's ground truth id map and a prediction that moves its segments' borders
    records, outputs = [], []
    for _ in range(4):
        gt = np.zeros((30, 40), np.int64)
        gt[:15, :20], gt[:15, 20:], gt[15:26] = 1, 2, 3
        pred = np.zeros((30, 40), np.int64)
        cut = rng.randint(10, 20)
        pred[:cut, :rng.randint(15, 25)], pred[:cut, 25:], pred[cut:] = 11, 12, 13
        segs = [{"id": 1, "category_id": 1}, {"id": 2, "category_id": 7}, {"id": 3, "category_id": int(rng.randint(2, 4))}]
        records.append({"pan_seg": gt, "segments_info": segs})
        outputs.append({"panoptic_seg": (pred, [{"id": 11, "category_id": 1}, {"id": 12, "category_id": 7},
                                                {"id": 13, "category_id": 2}])})
    out.append(("panoptic", COCOPanopticEvaluator({1, 7}), records, outputs))
    # rotated boxes
    records, outputs = [], []
    for img in range(4):
        gt = np.concatenate([rng.rand(4, 2) * 60 + 20, rng.rand(4, 2) * 20 + 5, rng.rand(4, 1) * 180 - 90], 1)
        cls = rng.randint(0, 3, 4)
        records.append({"image_id": img, "annotations": [{"category_id": int(c), "bbox": b.tolist()}
                                                         for c, b in zip(cls, gt)]})
        det = np.concatenate([gt + rng.randn(4, 5) * [1, 1, 1, 1, 8], gt[:2] + 10])
        outputs.append({"boxes": det.astype(np.float32), "scores": rng.rand(6).astype(np.float32),
                        "classes": np.concatenate([cls, cls[:2]]), "valid": rng.rand(6) < 0.9})
    out.append(("rotated_coco", RotatedCOCOEvaluator(["a", "b", "c"]), records, outputs))
    # YouTube-VIS: runner outputs from the ground truth's tubes, some frames moved or dropped
    json_file = synthetic.generate_synthetic_ytvis(os.path.join(root, "ytvis"), num_videos=4, num_frames=3, h=48,
                                                   w=64, seed=25)
    records = load_ytvis_json(json_file, os.path.join(root, "ytvis", "JPEGImages"))
    MetadataCatalog.get("dist_ytvis").set(json_file=json_file)
    with open(json_file) as f:
        import json

        anns = json.load(f)["annotations"]
    outputs = []
    for r in records:
        tubes = [a for a in anns if a["video_id"] == r["video_id"]]
        masks = [[None if rng.rand() < 0.2 else np.roll(polygons_to_bitmask(s, r["height"], r["width"]),
                                                        rng.randint(-3, 4), 1) for s in a["segmentations"]]
                 for a in tubes]
        outputs.append({"image_size": (r["height"], r["width"]), "pred_scores": rng.rand(len(tubes)).tolist(),
                        "pred_labels": [a["category_id"] - 1 for a in tubes], "pred_masks": masks})
    out.append(("ytvis", YTVISEvaluator("dist_ytvis"), records, outputs))
    for _, ev, _, _ in out:
        ev.reset()
    return out


# ---------------------------------------------------------------- the fixture
def _jax_idol_losses(jmodel, params, batch):
    """The metrics JAX's one-device step reports on the whole batch: its loss
    function's loss dict and weighted total at the step's parameters (the
    forward alone, under one jit: the update does not change them)."""
    weights = jax_weight_dict(dec_layers=2)

    @jax.jit
    def metrics(p, inputs):
        losses = jmodel.apply({"params": p}, *inputs, train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return {**losses, "total_loss": sum(losses[k] * weights[k] for k in losses if k in weights)}

    return {k: float(v) for k, v in metrics(params, jax_inputs(batch, PIXEL_MEAN, PIXEL_STD)).items()}


def _jax_sync_bn(params, stats, x, probe):
    """JAX's SyncBatchNorm under shard_map over 2 devices on the NHWC batch:
    (output, gradient of the probe's product, new running statistics)."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    jm = jax_layers.SyncBatchNorm(features=3, axis_name="data")

    def local(x, probe):
        def f(x):
            y, new = jm.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])
            return (y * probe).sum(), (y, new["batch_stats"])

        (_, (y, new)), g = jax.value_and_grad(f, has_aux=True)(x)
        return y, g, new

    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                               out_specs=(P("data"), P("data"), P()), check_vma=False))
    return jax.tree.map(np.asarray, fn(x, probe))


def _port_step(model, optimizer, step, inputs):
    """One step in this process: (metrics, parameters after, the gradients the update took)."""
    state = TrainState.create(model, optimizer)
    _, metrics = step(state, inputs)
    named = list(model.named_parameters())
    return ({k: float(v) for k, v in metrics.items()}, {n: p.detach().numpy().copy() for n, p in named},
            {n: p.grad.numpy().copy() for n, p in named})


def _retina_inputs():
    """Two 64x96 images, 3 and 1 objects among 6 slots."""
    rng = np.random.RandomState(30)
    images = rng.randn(2, 64, 96, 3).astype(np.float32)
    boxes = np.zeros((2, 6, 4), np.float32)
    boxes[..., 2:] = 1e-4
    labels = np.zeros((2, 6), np.int32)
    valid = np.zeros((2, 6), bool)
    for b, n in enumerate((3, 1)):
        for k in range(n):
            x1, y1 = rng.uniform(0, 56), rng.uniform(0, 32)
            boxes[b, k] = x1, y1, x1 + rng.uniform(12, 40), y1 + rng.uniform(10, 32)
            labels[b, k] = rng.randint(0, 4)
            valid[b, k] = True
    return images, labels, boxes, valid


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    in_dir, out_dir = tmp / "in", tmp / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    batch = tiny_batch(0, n_valid=(3, 1))
    jmodel = JaxIDOL(num_classes=5, hidden_dim=32, num_queries=NQ, nheads=4, dim_feedforward=64, enc_layers=1,
                     dec_layers=2, msda_impl="jnp", **TINY)
    jin = jax_inputs(batch, PIXEL_MEAN, PIXEL_STD)
    params = random_params(lambda: jmodel.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                                               *jin, train=False), seed=1)
    state = params_from_jax(jax.tree.map(np.asarray, params))
    rng = np.random.RandomState(31)
    clip = (rng.randn(4, 64, 96, 3).astype(np.float32), np.asarray([[64, 85], [56, 96], [64, 96], [60, 90]], np.int32))
    bn_x = (rng.randn(4, 3, 5, 6) * 2 + 1).astype(np.float32)
    bn_probe = rng.randn(4, 3, 5, 6).astype(np.float32)
    bn_params = {"bn": {"scale": (1 + 0.1 * rng.randn(3)).astype(np.float32),
                        "bias": (0.1 * rng.randn(3)).astype(np.float32)}}
    bn_stats = {"bn": {"mean": (0.1 * rng.randn(3)).astype(np.float32),
                       "var": (1 + rng.rand(3)).astype(np.float32)}}
    evaluators = _evaluator_inputs(str(tmp / "datasets"))
    inputs = dict(idol_kwargs={**TINY_IDOL, **TINY}, idol_state=state, idol_config=IDOL_CONFIG, idol_batch=batch,
                  retina_kwargs=RETINA, retina_batch=_retina_inputs(), clip=clip, bn_x=bn_x, bn_probe=bn_probe,
                  bn_state={"bn.weight": torch.from_numpy(bn_params["bn"]["scale"]),
                            "bn.bias": torch.from_numpy(bn_params["bn"]["bias"]),
                            "bn.mean": torch.from_numpy(bn_stats["bn"]["mean"]),
                            "bn.var": torch.from_numpy(bn_stats["bn"]["var"])},
                  evaluators=evaluators)
    with open(in_dir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)

    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, WORKER, str(in_dir), str(out_dir), port, str(rank)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    try:
        # the references, while the pair runs
        ref = {"jax_idol": _jax_idol_losses(jmodel, params, batch)}
        cfg = ytvis19_r50_cfg()
        model = IDOL(**TINY_IDOL, **TINY, dtype=torch.float32)
        model.load_state_dict(state)
        optimizer = solver.build_optimizer(cfg, model)
        step = make_train_step(model, optimizer, default_weight_dict(dec_layers=2), clip=solver.build_grad_clip(cfg))
        ref["idol"] = _port_step(model, optimizer, step,
                                 batch_to_model_inputs(batch, PIXEL_MEAN, PIXEL_STD, "cpu"))
        retina = RetinaNet(**RETINA)
        init_weights(retina, 3)
        optimizer = torch.optim.SGD(retina.parameters(), lr=0.01)
        images, labels, boxes, valid = (torch.from_numpy(a) for a in _retina_inputs())
        ref["retina_before"] = {n: p.detach().numpy().copy() for n, p in retina.named_parameters()}
        ref["retinanet"] = _port_step(retina, optimizer,
                                      make_train_step(retina, optimizer, {"loss_cls": 1.0, "loss_box_reg": 1.0}),
                                      (images, DetTargets(labels, boxes, valid)))
        ref["idol_before"] = {k: v.numpy() for k, v in state.items()}
        from jax.sharding import Mesh

        mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
        specs = jax_infer_tp_specs(params, mesh, min_features=64)
        ref["jax_tp"] = {".".join(str(k.key) for k in path): spec for path, spec in
                         jax.tree_util.tree_flatten_with_path(
                             specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        ref["jax_bn"] = _jax_sync_bn(bn_params, bn_stats, np.moveaxis(bn_x, 1, -1), np.moveaxis(bn_probe, 1, -1))
        ref["eval"] = {}
        for name, ev, records, outputs in evaluators:
            ev = copy.deepcopy(ev)
            ev.process(records, outputs)
            ref["eval"][name] = ev.evaluate()
    finally:
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=240)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0])
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-6000:]}"
    ranks = []
    for rank in range(2):
        with open(out_dir / f"rank{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, ref, out_dir


# ---------------------------------------------------------------- the step
def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_the_pair_joined_one_group(run):
    ranks, _, _ = run
    assert [r["world"] for r in ranks] == [(0, 2, 1), (1, 2, 1)]
    assert ranks[0]["gathered"] == ranks[1]["gathered"] == [{"rank": 0}, {"rank": 1}]


def test_two_rank_idol_step_equals_jax_one_device_step(run):
    ranks, ref, _ = run
    assert [r["idol"]["instances"] for r in ranks] == [3, 1]      # the ranks' counts differ
    want = ref["jax_idol"]
    for r in ranks:
        got = r["idol"]["metrics"]
        assert set(want) <= set(got)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL, err_msg=k)


def test_two_rank_idol_step_equals_one_process_step(run):
    """The same losses; the same clipped gradients (each tensor within 1e-3 of
    its norm plus 1e-6 of the global norm: the ranks' partial sums); the same
    parameters after AdamW's first update, lr x g / (|g| + eps): within 1e-3
    of lr where |g| is 100 eps or more, where the sign is the gradient's; and
    every rank's parameters equal."""
    ranks, ref, _ = run
    metrics, after, grads = ref["idol"]
    before = ref["idol_before"]
    for r in ranks:
        for k, v in metrics.items():
            np.testing.assert_allclose(r["idol"]["metrics"][k], v, rtol=TOL_SAME, err_msg=k)
        assert math.isfinite(r["idol"]["second_total"])
    lr = 1e-4
    global_norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values()))
    moved = 0
    for name, want in after.items():
        got = ranks[0]["idol"]["after"][name]
        np.testing.assert_array_equal(got, ranks[1]["idol"]["after"][name], err_msg=name)
        g, g_want = ranks[0]["idol"]["grads"][name], grads[name]
        assert np.linalg.norm(g - g_want) <= 1e-3 * np.linalg.norm(g_want) + 1e-6 * global_norm, name
        spacing = 2 * np.spacing(np.abs(want))
        signed = np.abs(g_want) >= 100 * 1e-8
        assert (np.abs(got - want) <= np.where(signed, 1e-3 * lr, 2 * lr) + spacing).all(), name
        moved += not np.array_equal(want, before[name])
    assert moved > 100


def test_two_rank_retinanet_step_equals_one_process_step(run):
    """The same losses; SGD's updates lr x g within 1e-3 of each tensor's
    (the ranks' partial sums); every rank's parameters equal."""
    ranks, ref, _ = run
    metrics, after, _ = ref["retinanet"]
    before = ref["retina_before"]
    for r in ranks:
        for k, v in metrics.items():
            np.testing.assert_allclose(r["retinanet"]["metrics"][k], v, rtol=TOL_SAME, err_msg=k)
        assert math.isfinite(r["retinanet"]["second_total"])
    for name, want in after.items():
        got = ranks[0]["retinanet"]["after"][name]
        np.testing.assert_array_equal(got, ranks[1]["retinanet"]["after"][name], err_msg=name)
        assert _rel(got - before[name], want - before[name]) <= 1e-3 or np.abs(want - before[name]).max() < 1e-9, name


# ---------------------------------------------------------------- tensor and time parallelism
def test_infer_tp_specs_selects_jax_parameters(run):
    ranks, ref, _ = run
    from jax.sharding import PartitionSpec as P

    def port_name(path):
        head, _, leaf = path.rpartition(".")
        return f"{head}.weight" if leaf in ("kernel", "scale") else path

    want = sorted(port_name(k) for k, s in ref["jax_tp"].items() if s != P())
    got = ranks[0]["tp"]["selected"]
    assert got == ranks[1]["tp"]["selected"] == want and len(want) > 50
    # a kernel's flax output axis is the port weight's dim 0
    dims = ranks[0]["tp"]["dims"]
    assert dims["transformer.encoder_0.linear1.weight"] == 0


def test_apply_tp_gives_the_replicated_losses(run):
    ranks, _, _ = run
    for r in ranks:
        tp = r["tp"]
        assert len(tp["sharded"]) > 50 and tp["grads_finite"]
        assert "backbone.conv1.weight" not in tp["sharded"]                     # K2 reads it whole
        assert "transformer.encoder_0.linear1.weight" not in tp["sharded"]   # K3 reads it whole
        for k, v in tp["plain"].items():
            np.testing.assert_allclose(tp["tp"][k], v, rtol=RTOL, atol=ATOL, err_msg=k)


def test_time_sharded_inference_equals_one_process(run):
    ranks, _, _ = run
    whole = ranks[0]["time"]["whole"]
    for r in ranks:
        got = r["time"]["sharded"]
        assert got.keys() == whole.keys() and got["pred_logits"].shape[0] == 4
        # the CPU's convolutions block a batch of 2 frames otherwise than one of 4: each output at 1e-5 of its largest
        for k, v in whole.items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=TOL_SAME * np.abs(v).max(), err_msg=k)


# ---------------------------------------------------------------- the evaluators
def _close(got, want, path="results"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    else:
        assert abs(got - want) <= TOL_EVAL * max(1.0, abs(want)), (path, got, want)


@pytest.mark.parametrize("name", ["coco", "lvis", "pascal_voc", "cityscapes_instance", "cityscapes_sem_seg",
                                  "sem_seg", "panoptic", "rotated_coco", "ytvis"])
def test_evaluator_on_two_halves_equals_one_process(run, name):
    ranks, ref, _ = run
    want = ref["eval"][name]
    assert want and all(v for v in want.values())
    _close(ranks[0]["eval"][name], want)
    assert ranks[1]["eval"][name] is None


# ---------------------------------------------------------------- SyncBatchNorm and the logs
def test_two_rank_sync_batch_norm_equals_jax_shard_map(run):
    ranks, ref, _ = run
    y, grad, stats = ref["jax_bn"]
    got_y = np.concatenate([np.moveaxis(r["bn"]["y"], 1, -1) for r in ranks])
    got_g = np.concatenate([np.moveaxis(r["bn"]["grad"], 1, -1) for r in ranks])
    np.testing.assert_allclose(got_y, y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_g, grad, rtol=1e-5, atol=1e-5)
    for r in ranks:
        for k in ("mean", "var"):
            np.testing.assert_allclose(r["bn"][k], stats["bn"][k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_rank_one_writes_its_own_log(run):
    _, _, out_dir = run
    logs = out_dir / "logs"
    assert sorted(os.listdir(logs)) == ["log.txt", "log.txt.rank1"]
    assert "rank 1 of 2" in (logs / "log.txt.rank1").read_text()
    assert "rank 0 of 2" in (logs / "log.txt").read_text()


# ---------------------------------------------------------------- samplers and loaders (this process)
@pytest.mark.parametrize("shard", [0, 1])
def test_samplers_shard_as_jax(shard):
    it = iter(build.TrainingSampler(7, seed=3, shard_index=shard, num_shards=2))
    jit = iter(jax_build.TrainingSampler(7, seed=3, shard_index=shard, num_shards=2))
    assert [next(it) for _ in range(15)] == [next(jit) for _ in range(15)]
    records = [{"annotations": [[{"category_id": c}] for c in cats]} for cats in ([1], [1, 2], [3], [1, 3], [2])]
    it = iter(build.RepeatFactorTrainingSampler(records, 0.5, seed=4, shard_index=shard, num_shards=2))
    jit = iter(jax_build.RepeatFactorTrainingSampler(records, 0.5, seed=4, shard_index=shard, num_shards=2))
    assert [next(it) for _ in range(15)] == [next(jit) for _ in range(15)]
    assert list(build.InferenceSampler(7, shard, 2)) == list(jax_build.InferenceSampler(7, shard, 2))


@pytest.fixture(scope="module")
def ytvis_records(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ytvis_loader"))
    json_file = jax_generate_synthetic_ytvis(root, num_videos=4, num_frames=6)
    image_root = os.path.join(root, "JPEGImages")
    return jax_load_ytvis_json(json_file, image_root), load_ytvis_json(json_file, image_root)


@pytest.mark.parametrize("shard", [0, 1])
def test_train_loader_shards_as_jax(ytvis_records, shard):
    from vnext_tpu.config import add_idol_config as jax_add_idol_config
    from vnext_tpu.config import get_cfg as jax_get_cfg
    from vnext_tpu_torch.config import add_idol_config, get_cfg

    cfgs = []
    for get, add in ((jax_get_cfg, jax_add_idol_config), (get_cfg, add_idol_config)):
        cfg = get()
        add(cfg)
        cfg.merge_from_file(os.path.join(REPO, "configs", "quick_schedules", "idol_instant_test.yaml"))
        cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", "4"])
        cfgs.append(cfg)
    jax_records, records = ytvis_records
    want = jax_build.build_vis_train_loader(cfgs[0], dataset_dicts=jax_records, seed=5, shard_index=shard, num_shards=2)
    got = build.build_vis_train_loader(cfgs[1], dataset_dicts=records, seed=5, shard_index=shard, num_shards=2)
    for _ in range(2):
        a, b = next(got), next(want)
        assert a["key_image"].shape[0] == 2 and a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    test = list(build.build_vis_test_loader(dataset_dicts=records, shard_index=shard, num_shards=2))
    assert [r["video_id"] for r in test] == [r["video_id"] for r in records[shard::2]]


def test_launch_of_one_process_calls_straight_through():
    assert launch(lambda a, b: a + b, 1, num_machines=1, args=(2, 3), device="cpu") == 5
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="dist-url"):
        launch(print, 1, num_machines=2, dist_url="auto", device="cpu")


@pytest.mark.parametrize("shard", [0, 1])
def test_detection_loader_shards_as_jax(tmp_path_factory, shard):
    """``SOLVER.IMS_PER_BATCH // 2`` images a rank from its shard of the
    sampler, its mapper drawing from ``seed * 1000 + shard``, as JAX's."""
    from vnext_tpu.config import add_idol_config as jax_add_idol_config
    from vnext_tpu.config import get_cfg as jax_get_cfg
    from vnext_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
    from vnext_tpu.data.datasets.synthetic import register_synthetic_coco as jax_register_synthetic_coco
    from vnext_tpu.engine.detection import build_detection_train_loader as jax_loader
    from vnext_tpu_torch.config import add_idol_config, get_cfg
    from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_coco
    from vnext_tpu_torch.engine import detection

    jax_register_synthetic_coco(root=str(tmp_path_factory.mktemp("synth") / "coco_synthetic_tiny"))
    register_synthetic_coco(root=os.path.dirname(JaxMetadataCatalog.get("coco_synthetic_tiny").json_file))
    cfgs = []
    for get, add in ((jax_get_cfg, jax_add_idol_config), (get_cfg, add_idol_config)):
        cfg = get()
        add(cfg)
        cfg.merge_from_file(os.path.join(REPO, "configs", "quick_schedules", "mask_rcnn_R_18_instant_test.yaml"))
        cfg.merge_from_list(["SOLVER.IMS_PER_BATCH", "4"])
        cfgs.append(cfg)
    want = jax_loader(cfgs[0], seed=7, shard_index=shard, num_shards=2)
    got = detection.build_detection_train_loader(cfgs[1], seed=7, shard_index=shard, num_shards=2)
    for _ in range(2):
        a, b = next(got), next(want)
        assert a["image"].shape[0] == 2 and a.keys() == b.keys() and a["image_id"] == b["image_id"]
        for k in b:
            if k != "image_id":
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
