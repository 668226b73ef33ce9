"""Cascade R-CNN and keypoint R-CNN in the port against the JAX package, on
the CPU in f32, with the keypoint head, its loss and decoding, the OKS
evaluator, and the entry point on the quick schedules.

Each model is tiny (ResNet-18, FPN 32 channels, 4 classes, 32 proposals
after NMS, an ROI batch of 16 at 0.25 positive, two images at 64x96 with true
sizes 64x85 and 56x96, 6 ground-truth slots of which 3 and 2 hold objects,
each with 17 keypoints), built once from a random flax tree
(``random_params``) with the RPN's ``anchor_deltas`` kernel scaled by 0.01, as
tests/test_torch_rcnn_train.py builds Mask R-CNN, so that the proposals stay
near their anchors inside the image, and the cascade's ``bbox_pred`` kernels
likewise, so that each stage refines its boxes a little and the last stage,
at IoU 0.7, still has a foreground. One jitted JAX function per model
returns its losses, every parameter's gradient and its inference. The port
draws its sampling priorities from ``rcnn.sampling_priorities``, replaced
here by JAX's ``jax.random.uniform`` arrays for the same keys: the RPN's from
the step's key, the cascade's stage 0 from ``fold_in(key, 0)``, the standard
heads' from ``fold_in(key, 7)``.

Tolerances (f32 on both sides, the convolutions' sums in other orders): the
losses at 1e-4 relative; every gradient at 1e-4 of its norm plus a floor of
1e-6 of the global norm; the detections' kept slots and classes exactly,
their boxes, scores and keypoints at 2e-4 of their largest (as
tests/test_torch_rcnn.py holds Mask R-CNN's); the keypoint head and the 4x4
transposed convolution at 1e-5 of their largest; the heatmap targets and the
argmax exactly, the decoded keypoints at 1e-6 (one f32 rounding in another
order); the OKS AP dict equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.evaluation.coco_eval import COCOEvaluator as JaxCOCOEvaluator
from vnext_tpu.evaluation.coco_eval import compute_oks_matrix as jax_oks
from vnext_tpu.models.rcnn import GeneralizedRCNN as JaxRCNN
from vnext_tpu.models.retinanet import DetTargets as JaxDetTargets
from vnext_tpu.models.roi_heads_extra import KRCNNConvDeconvUpsampleHead as JaxKRCNNHead
from vnext_tpu.models.roi_heads_extra import keypoint_rcnn_loss as jax_keypoint_loss
from vnext_tpu.structures.keypoints import Keypoints as JaxKeypoints
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.config import add_idol_config, get_cfg
from vnext_tpu_torch.data.catalog import MetadataCatalog
from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_coco
from vnext_tpu_torch.engine import detection
from vnext_tpu_torch.evaluation.coco_eval import COCOEvaluator, compute_oks_matrix
from vnext_tpu_torch.models import rcnn
from vnext_tpu_torch.models.layers import ConvTranspose
from vnext_tpu_torch.models.rcnn import DetTargets, GeneralizedRCNN
from vnext_tpu_torch.models.roi_heads_extra import KRCNNConvDeconvUpsampleHead, keypoint_rcnn_loss
from vnext_tpu_torch.structures.keypoints import Keypoints
from vnext_tpu_torch.tools import train_net

from _torch_helpers import random_params, t

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK = os.path.join(REPO, "configs", "quick_schedules")
H, W, K, NKP = 64, 96, 6, 17
SIZES = np.asarray([[64, 85], [56, 96]], np.int32)
TINY = dict(num_classes=4, backbone_depth=18, fpn_channels=32, proposals_per_image=32, roi_batch_per_image=16,
            roi_pos_fraction=0.25)
TOL, GRAD_FLOOR = 1e-4, 1e-6


def _targets(seed):
    """Boxes of 3 and 2 objects (the rest padded as the mapper pads them),
    labels, validity, and 17 keypoints an object: inside its box, a few
    invisible and a few just outside it."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((2, K, 4), np.float32)
    boxes[..., 2:] = 1e-4
    labels = np.zeros((2, K), np.int32)
    valid = np.zeros((2, K), bool)
    kps = np.zeros((2, K, NKP, 3), np.float32)
    for b, n in enumerate((3, 2)):
        for k in range(n):
            x1, y1 = rng.uniform(0, SIZES[b, 1] - 30), rng.uniform(0, SIZES[b, 0] - 24)
            x2, y2 = x1 + rng.uniform(16, 30), y1 + rng.uniform(12, 24)
            boxes[b, k] = x1, y1, x2, y2
            labels[b, k] = rng.randint(0, TINY["num_classes"])
            valid[b, k] = True
            kps[b, k, :, 0] = rng.uniform(x1 - 2, x2 + 2, NKP)
            kps[b, k, :, 1] = rng.uniform(y1 - 2, y2 + 2, NKP)
            kps[b, k, :, 2] = np.where(rng.rand(NKP) < 0.8, 2, 0)
    return labels, boxes, valid, kps


class Priorities:
    """``rcnn.sampling_priorities`` replaced: the given arrays in turn."""

    def __init__(self, arrays):
        self.arrays, self.i = arrays, 0

    def __call__(self, shape, generator, device):
        out = torch.from_numpy(self.arrays[self.i % len(self.arrays)])
        assert tuple(out.shape) == tuple(shape), (tuple(out.shape), tuple(shape))
        self.i += 1
        return out.to(device)


def _by_name(tree):
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree)).items()}


def _scaled(tree, *path, by=0.01):
    """``tree`` with the kernel at ``path`` scaled by ``by``."""
    if not path:
        return {**tree, "kernel": tree["kernel"] * by}
    return {**tree, path[0]: _scaled(tree[path[0]], *path[1:], by=by)}


# the variant: its constructor's switch, and the fold of the key that draws the ROI sample's priorities
VARIANTS = {"cascade": (dict(cascade_on=True), 0), "keypoint": (dict(keypoint_on=True), 7)}
LOSS_KEYS = {"cascade": ["loss_rpn_cls", "loss_rpn_loc"] + [f"loss_{p}_stage{k}" for k in range(3)
                                                               for p in ("cls", "box_reg")],
             "keypoint": ["loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_keypoint"]}


@pytest.fixture(scope="module", params=list(VARIANTS))
def tiny(request):
    name = request.param
    switch, fold = VARIANTS[name]
    rng = np.random.RandomState(0)
    images = rng.randn(2, H, W, 3).astype(np.float32)
    labels, boxes, valid, kps = _targets(1)
    jmodel = JaxRCNN(**TINY, **switch)
    jt = JaxDetTargets(labels=jnp.asarray(labels), boxes=jnp.asarray(boxes), valid=jnp.asarray(valid))
    key = jax.random.PRNGKey(3)
    extra = {"gt_keypoints": jnp.asarray(kps)} if name == "keypoint" else {}
    args = (jnp.asarray(images), jnp.asarray(SIZES), jt)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), *args, train=True, rng_key=key, **extra),
                           seed=5)
    params = _scaled(params, "rpn", "anchor_deltas")
    if name == "cascade":                  # each stage's refinement small, so that the last stage has a foreground
        for k in range(3):
            params = _scaled(params, "roi_heads", f"stage{k}", "bbox_pred")

    def run(p, images, sizes, targets, extra):
        out, vjp = jax.vjp(lambda q: jmodel.apply({"params": q}, images, sizes, targets, train=True, rng_key=key,
                                                  **extra), p)
        grads = vjp({k: jnp.ones_like(v) for k, v in out.items()})[0]
        det = jmodel.apply({"params": p}, images, sizes, method=JaxRCNN.inference)
        return out, grads, det

    losses, grads, det = jax.jit(run)(params, *args, extra)
    n_anchors = sum(3 * -(-H // s) * -(-W // s) for s in (4, 8, 16, 32, 64))
    priorities = [np.asarray(jax.random.uniform(key, (2, n_anchors))),
                  np.asarray(jax.random.uniform(jax.random.fold_in(key, fold), (2, TINY["proposals_per_image"] + K)))]
    want = dict(losses={k: float(v) for k, v in losses.items()}, grads=_by_name(grads),
                det=jax.tree.map(np.asarray, det))

    port = GeneralizedRCNN(**TINY, **switch).train()
    load_from_jax(port, params)
    targets = DetTargets(*(torch.from_numpy(a) for a in (labels, boxes, valid)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rcnn, "sampling_priorities", Priorities(priorities))
        got = port(t(images), torch.from_numpy(SIZES), targets, None,
                   torch.from_numpy(kps) if name == "keypoint" else None)
        sum(got.values()).backward()
    port.eval()
    with torch.no_grad():
        det = port(t(images), torch.from_numpy(SIZES))
    return dict(name=name, want=want, port=port, losses={k: float(v.detach()) for k, v in got.items()},
                det={k: v.numpy() for k, v in det.items()})


def _close(got, want, scale):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * max(np.abs(want).max(), 1e-30))


def test_losses_match_jax(tiny):
    want, got = tiny["want"]["losses"], tiny["losses"]
    assert list(got) == LOSS_KEYS[tiny["name"]] and set(got) == set(want)    # JAX's order (jit sorts its dict)
    for k, v in want.items():
        assert abs(got[k] - v) <= TOL * abs(v), (k, got[k], v)
    assert all(v > 0 for v in want.values()), want


def test_every_gradient_matches_jax(tiny):
    """Every parameter's gradient, the frozen ones' included; the cascade's
    later stages and the keypoint head are reached."""
    want, port = tiny["want"]["grads"], tiny["port"]
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(got) == set(want)
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want.values()))
    errs = {n: np.linalg.norm(g - want[n]) / (TOL * np.linalg.norm(want[n]) + GRAD_FLOOR * norm)
            for n, g in got.items()}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert worst[0][1] <= 1.0, worst
    reached = ("roi_heads.stage2.bbox_pred.weight" if tiny["name"] == "cascade"
               else "roi_heads.keypoint_head.score_lowres.weight")
    assert np.linalg.norm(want[reached]) > 0


def test_inference_matches_jax(tiny):
    """The detections: kept slots and classes exactly, boxes, scores (and
    keypoints, their scores included) at 2e-4 of their largest."""
    want, got = tiny["want"]["det"], tiny["det"]
    keys = ["boxes", "classes", "scores", "valid"] + (["keypoints"] if tiny["name"] == "keypoint" else [])
    assert sorted(got) == sorted(want) == sorted(keys)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    assert got["valid"].sum() > 0
    for k in keys:
        if k not in ("valid", "classes"):
            _close(got[k], want[k], 2e-4)


# ---------------------------------------------------------------- the keypoint head, its loss and decoding
def test_keypoint_head_and_4x4_conv_transpose_match_jax():
    """``KRCNNConvDeconvUpsampleHead`` (4 convolutions of 256, the 4x4 stride-2
    ``score_lowres`` at flax's "SAME", x2 bilinear) on 7x7 pooled features:
    28x28 heatmaps at 1e-5 of their largest; the 4x4 case's ``lax_pads`` are
    (2, 2), and a lone ``ConvTranspose`` of 4x4 at stride 2 on an odd side
    equals flax's."""
    assert ConvTranspose.lax_pads(4, 2) == (2, 2)
    rng = np.random.RandomState(4)
    pooled = rng.randn(3, 7, 7, 32).astype(np.float32)
    head = JaxKRCNNHead(num_keypoints=NKP, conv_dims=(256,) * 4)
    params = random_params(lambda: head.init(jax.random.PRNGKey(0), jnp.asarray(pooled)), seed=2)
    want = jax.jit(lambda p, x: head.apply({"params": p}, x))(params, pooled)
    port = KRCNNConvDeconvUpsampleHead(32, NKP)
    load_from_jax(port, params)
    got = port(t(pooled))
    assert got.shape == want.shape == (3, 28, 28, NKP)
    _close(got.detach(), want, 1e-5)

    import flax.linen as fnn

    x = rng.randn(2, 5, 9, 6).astype(np.float32)
    deconv = fnn.ConvTranspose(4, (4, 4), strides=(2, 2))
    p = random_params(lambda: deconv.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=3)
    want = np.asarray(deconv.apply({"params": p}, x))
    layer = ConvTranspose(6, 4, 4, 2)
    layer.load_state_dict(params_from_jax(p))
    got = layer(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 10, 18, 4)
    _close(got.detach(), want, 1e-5)


def test_keypoint_loss_and_heatmaps_match_jax():
    """``to_heatmap`` (floor and clip at the cells' edges, the box's right
    and bottom edges outside, invisible points), ``keypoint_rcnn_loss`` at
    1e-5 relative, and ``from_heatmap``'s argmax exactly on heatmaps with ties
    (the first maximal cell wins), its positions and scores at 1e-6."""
    rng = np.random.RandomState(6)
    n, s = 5, 28
    rois = np.asarray([[4, 6, 32, 34], [0, 0, 14, 7], [10.5, 3.25, 24.5, 40], [2, 2, 2.0001, 9], [-3, -3, 50, 60]],
                      np.float32)
    kps = np.zeros((n, NKP, 3), np.float32)
    for i, (x1, y1, x2, y2) in enumerate(rois):
        kps[i, :, 0] = rng.uniform(x1 - 1, x2 + 1, NKP)
        kps[i, :, 1] = rng.uniform(y1 - 1, y2 + 1, NKP)
        kps[i, :, 2] = rng.randint(0, 3, NKP)
    kps[0, :4, :2] = [[4, 6], [32, 34], [31.999, 33.999], [18, 20]]         # corners and a cell edge
    kps[0, :4, 2] = 2
    logits = rng.randn(n, s, s, NKP).astype(np.float32)
    logits[1, 3, 5, :] = logits[1, 20, 2, :] = 50.0                          # ties: (3, 5) comes first
    fg = np.asarray([1, 1, 0, 1, 1], np.float32)
    w_idx, w_valid = JaxKeypoints(kps).to_heatmap(jnp.asarray(rois), s)
    idx, valid = Keypoints(kps).to_heatmap(t(rois), s)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(w_valid))
    assert 0 < int(valid.sum()) < valid.numel()
    want = float(jax_keypoint_loss(jnp.asarray(logits), jnp.asarray(kps), jnp.asarray(rois), jnp.asarray(fg)))
    got = float(keypoint_rcnn_loss(t(logits), t(kps), t(rois), t(fg)))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    flat = logits.transpose(0, 3, 1, 2).reshape(n, NKP, s * s)
    np.testing.assert_array_equal(t(flat).argmax(-1).numpy(), np.asarray(jnp.argmax(jnp.asarray(flat), -1)))
    decoded = Keypoints.from_heatmap(t(logits), t(rois)).numpy()
    np.testing.assert_allclose(decoded, np.asarray(JaxKeypoints.from_heatmap(jnp.asarray(logits), jnp.asarray(rois))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(decoded[1, :, :2], np.broadcast_to([(5.5 / s) * 14, (3.5 / s) * 7], (NKP, 2)),
                               rtol=1e-6)


# ---------------------------------------------------------------- the OKS evaluator
@pytest.fixture(scope="module")
def synthetic_coco(tmp_path_factory):
    """The port's "coco_synthetic_tiny" (8 images at 160x224, 17 keypoints an
    object) in a test folder, its metadata given to the JAX catalog as well."""
    from vnext_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog

    register_synthetic_coco(root=str(tmp_path_factory.mktemp("synth") / "coco_synthetic_tiny"))
    meta = MetadataCatalog.get("coco_synthetic_tiny")
    jmeta = JaxMetadataCatalog.get("coco_synthetic_oks")
    if jmeta.get("json_file") is None:
        jmeta.set(json_file=meta.json_file, evaluator_type="coco",
                  thing_dataset_id_to_contiguous_id=meta.thing_dataset_id_to_contiguous_id)
    return meta


def test_oks_ap_equals_jax(synthetic_coco, tmp_path):
    """The ``keypoints`` task on outputs made from the ground truth with
    jitter (some keypoints far off, some detections spurious), next to bbox:
    the AP dicts equal to JAX's ``COCOEvaluator``'s, AP neither 0 nor 1, and
    the OKS matrix equal on the same annotations."""
    import json

    with open(synthetic_coco.json_file) as f:
        gt = json.load(f)
    id_map = synthetic_coco.thing_dataset_id_to_contiguous_id
    rng = np.random.RandomState(8)
    records, outputs = [], []
    for im in gt["images"]:
        anns = [a for a in gt["annotations"] if a["image_id"] == im["id"]]
        n = len(anns) + 2
        boxes = np.zeros((n, 4), np.float32)
        kps = np.zeros((n, NKP, 3), np.float32)
        classes = np.zeros(n, np.int64)
        for i, a in enumerate(anns):
            x, y, bw, bh = a["bbox"]
            boxes[i] = x, y, x + bw, y + bh
            kps[i] = np.asarray(a["keypoints"], np.float32).reshape(NKP, 3)
            kps[i, :, :2] += rng.randn(NKP, 2) * rng.choice([0.5, 3.0, 12.0]) * np.sqrt(bw * bh) / 20
            classes[i] = id_map[a["category_id"]]
        for i in range(len(anns), n):
            x, y = rng.uniform(0, im["width"] - 40), rng.uniform(0, im["height"] - 40)
            boxes[i] = x, y, x + 30, y + 30
            kps[i, :, 0], kps[i, :, 1] = rng.uniform(x, x + 30, NKP), rng.uniform(y, y + 30, NKP)
            classes[i] = rng.randint(0, 3)
        kps[:, :, 2] = rng.rand(n, NKP)
        records.append({"image_id": im["id"], "height": im["height"], "width": im["width"]})
        outputs.append({"boxes": boxes, "scores": rng.uniform(0.1, 1.0, n).astype(np.float32), "classes": classes,
                        "valid": np.ones(n, bool), "keypoints": kps})
    got_ev = COCOEvaluator("coco_synthetic_tiny", ("bbox", "keypoints"), str(tmp_path / "port"))
    want_ev = JaxCOCOEvaluator("coco_synthetic_oks", ("bbox", "keypoints"), str(tmp_path / "jax"))
    for ev in (got_ev, want_ev):
        ev.reset()
        ev.process(records, outputs)
    got, want = got_ev.evaluate(), want_ev.evaluate()
    assert sorted(got) == sorted(want) == ["bbox", "keypoints"]
    for task in got:
        assert sorted(got[task]) == sorted(want[task]), task
        for k, v in want[task].items():
            assert got[task][k] == v or (np.isnan(v) and np.isnan(got[task][k])), (task, k, got[task][k], v)
    assert sorted(got["keypoints"]) == ["AP", "AP50", "AP75", "APl", "APm", "AR@20"]
    assert 0.05 < got["keypoints"]["AP"] < 0.95, got["keypoints"]
    with open(tmp_path / "port" / "coco_instances_results.json") as f:
        entries = json.load(f)
    dts = [e for e in entries if e["image_id"] == gt["images"][0]["id"]]
    gts = [a for a in gt["annotations"] if a["image_id"] == gt["images"][0]["id"]]
    np.testing.assert_array_equal(compute_oks_matrix(dts, gts), jax_oks(dts, gts))


# ---------------------------------------------------------------- the entry point
@pytest.fixture(scope="module")
def two_images(synthetic_coco, tmp_path_factory):
    """A 2-image synthetic COCO set for the evaluations (the quick schedules'
    8-image set trains)."""
    register_synthetic_coco("coco_synthetic_two", root=str(tmp_path_factory.mktemp("synth") / "two"), num_images=2)
    return "coco_synthetic_two"


@pytest.mark.parametrize("config", ["retinanet_R_18_instant_test.yaml", "fcos_R_18_instant_test.yaml",
                                    "keypoint_rcnn_R_18_instant_test.yaml"],
                         ids=["retinanet", "fcos", "keypoint_rcnn"])
def test_train_net_serves_and_trains(two_images, tmp_path, config):
    """``train_net.main`` on the quick schedule with ``MODEL.DEVICE cpu``:
    ``--eval-only`` scores the 2-image set (bbox, and OKS for keypoint R-CNN,
    held to ``TEST.EXPECTED_RESULTS``), then 2 training steps with every loss
    of ``detection.loss_keys`` finite (``DATASETS.TEST "()"``: the
    evaluation was just run)."""
    cfg_file = os.path.join(QUICK, config)
    opts = ["MODEL.DEVICE", "cpu", "DATASETS.TEST", f"('{two_images}',)"]
    results = train_net.main(["--config-file", cfg_file, "--eval-only", *opts, "OUTPUT_DIR", str(tmp_path / "eval")])
    tasks = ["bbox", "keypoints"] if config.startswith("keypoint") else ["bbox"]
    assert list(results) == [two_images] and sorted(results[two_images]) == tasks
    trainer = train_net.main(["--config-file", cfg_file, *opts, "SOLVER.MAX_ITER", "2", "DATASETS.TEST", "()",
                              "OUTPUT_DIR", str(tmp_path / "train")])
    assert trainer.iter == 2
    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file(cfg_file)
    hist = trainer.storage.histories()
    keys = sorted(k for k in hist if k.startswith("loss_"))
    assert keys == sorted(detection.loss_keys(cfg))
    for k in keys + ["total_loss"]:
        assert hist[k].count() == 2 and np.isfinite(hist[k].values()).all(), (k, hist[k].values())
    assert ("loss_keypoint" in keys) == config.startswith("keypoint")
    assert ("loss_fcos_ctr" in keys) == config.startswith("fcos")
