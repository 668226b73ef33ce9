"""R-CNN training in the port against the JAX package, on the CPU in f32.

One tiny Mask R-CNN (ResNet-18, FPN 32 channels, 4 classes, 32 proposals
after NMS, an ROI batch of 16 at 0.25 positive, two images at 64x96 with true
sizes 64x85 and 56x96, 6 ground-truth slots of which 3 and 2 hold objects) is
built once from a random flax tree (``random_params``: no init is compiled)
with the RPN's ``anchor_deltas`` kernel scaled by 0.01, so that the proposals
stay near their anchors inside the image: at flax's scale the sampled
background ROIs are boxes of zero side clipped onto the image's edge, where
``clip`` has no slope, and the gradient the ROI losses send into the RPN
through the proposals is exactly 0 in both packages. One jitted JAX function
returns the five losses, every parameter's gradient, and the gradient of the
ROI losses alone (a second cotangent through the same ``vjp``). The port draws
its sampling priorities from ``rcnn.sampling_priorities``, which the tests
replace with JAX's ``jax.random.uniform`` arrays for the same keys.

Tolerances (f32 on both sides, the convolutions' sums in other orders):
the losses at 1e-5 relative, every gradient at 1e-4 of its norm plus an
absolute floor of 1e-6 of the global norm (a gradient that is ~0 in exact
arithmetic is rounding noise on both sides, as tests/test_torch_train_step.py
holds IDOL's); the RPN's losses on given inputs at 1e-5 with the selections
equal; ``roi_align_per_item`` at 1e-5 of its 0/1 samples' scale, as
``roi_align`` is held in tests/test_torch_rcnn.py; loader batches and frozen parameters bit for bit; the
solver against optax at 1e-6 relative (one f32 rounding per operation).

Besides: the solver's recipes (SGD with momentum or Nesterov and no weight
decay, WarmupCosineLR, clip by value) against optax over a few steps, the
solver's frozen and backbone masks on GeneralizedRCNN, and the entry point
(``train_net.main``) training the R-18 quick schedules on the synthetic COCO
set, resumed bit for bit, and ProposalNetwork.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vnext_tpu.config import add_idol_config as jax_add_idol_config
from vnext_tpu.config import get_cfg as jax_get_cfg
from vnext_tpu.data.catalog import MetadataCatalog as JaxMetadataCatalog
from vnext_tpu.data.datasets.synthetic import register_synthetic_coco as jax_register_synthetic_coco
from vnext_tpu.data.detection_mapper import stack_detection_batch as jax_stack_detection_batch
from vnext_tpu.engine.detection import build_detection_train_loader as jax_build_detection_train_loader
from vnext_tpu.models.dense_heads import iou_matcher as jax_iou_matcher
from vnext_tpu.models.rcnn import RPN as JaxRPN
from vnext_tpu.models.rcnn import GeneralizedRCNN as JaxRCNN
from vnext_tpu.models.retinanet import DetTargets as JaxDetTargets
from vnext_tpu.ops.roi_align import roi_align_per_item as jax_roi_align_per_item
from vnext_tpu.solver.build import backbone_mask as jax_backbone_mask
from vnext_tpu.solver.build import build_lr_schedule as jax_lr_schedule
from vnext_tpu.solver.build import build_optimizer as jax_build_optimizer
from vnext_tpu.solver.build import frozen_mask as jax_frozen_mask
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.config import add_idol_config, get_cfg
from vnext_tpu_torch.data.catalog import DatasetCatalog
from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_coco
from vnext_tpu_torch.data.detection_mapper import stack_detection_batch
from vnext_tpu_torch.engine import detection
from vnext_tpu_torch.models import rcnn
from vnext_tpu_torch.models.rcnn import RPN, DetTargets, GeneralizedRCNN
from vnext_tpu_torch.ops.roi_align import roi_align_per_item
from vnext_tpu_torch.solver import build as solver
from vnext_tpu_torch.tools import train_net

from _torch_helpers import random_params, t

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK = os.path.join(REPO, "configs", "quick_schedules")
H, W, K = 64, 96, 6
SIZES = np.asarray([[64, 85], [56, 96]], np.int32)
TINY = dict(num_classes=4, backbone_depth=18, fpn_channels=32, proposals_per_image=32, roi_batch_per_image=16,
            roi_pos_fraction=0.25, mask_on=True)
ROI_KEYS = ("loss_cls", "loss_box_reg", "loss_mask")
TOL_LOSS, TOL_GRAD, GRAD_FLOOR = 1e-5, 1e-4, 1e-6


def _targets(seed):
    """Boxes of 3 and 2 objects (the rest padded as the mapper pads them),
    labels, validity, and each object's bitmask (an ellipse in its box)."""
    rng = np.random.RandomState(seed)
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
    return labels, boxes, valid, masks


def _jax_priorities(key, shapes):
    """JAX's draws of one train forward: the RPN's from ``key``, the ROIs'
    from ``fold_in(key, 7)``."""
    return [np.asarray(jax.random.uniform(key, shapes[0])),
            np.asarray(jax.random.uniform(jax.random.fold_in(key, 7), shapes[1]))]


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
    """flax tree -> {port parameter name: numpy array} (the bridge's naming)."""
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.RandomState(0)
    images = rng.randn(2, H, W, 3).astype(np.float32)
    labels, boxes, valid, masks = _targets(1)
    jmodel = JaxRCNN(**TINY)
    jt = JaxDetTargets(labels=jnp.asarray(labels), boxes=jnp.asarray(boxes), valid=jnp.asarray(valid))
    key = jax.random.PRNGKey(3)
    args = (jnp.asarray(images), jnp.asarray(SIZES), jt)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), *args, train=True, rng_key=key,
                                               gt_masks=jnp.asarray(masks, jnp.float32)), seed=5)
    rpn = params["rpn"]
    params = {**params, "rpn": {**rpn, "anchor_deltas": {**rpn["anchor_deltas"],
                                                         "kernel": rpn["anchor_deltas"]["kernel"] * 0.01}}}

    def run(p, images, sizes, targets, gt_masks):
        def losses(q):
            return jmodel.apply({"params": q}, images, sizes, targets, train=True, rng_key=key, gt_masks=gt_masks)

        out, vjp = jax.vjp(losses, p)
        every = {k: jnp.ones_like(v) for k, v in out.items()}
        roi_only = {k: jnp.ones_like(v) if k in ROI_KEYS else jnp.zeros_like(v) for k, v in out.items()}
        grads = jax.vmap(lambda c: vjp(c)[0])(jax.tree.map(lambda a, b: jnp.stack([a, b]), every, roi_only))
        return out, jax.tree.map(lambda g: g[0], grads), jax.tree.map(lambda g: g[1], grads)

    losses, grads, roi_grads = jax.jit(run)(params, *args, jnp.asarray(masks, jnp.float32))
    n_anchors = sum(3 * -(-H // s) * -(-W // s) for s in (4, 8, 16, 32, 64))
    priorities = _jax_priorities(key, [(2, n_anchors), (2, TINY["proposals_per_image"] + K)])
    want = dict(losses={k: float(v) for k, v in losses.items()}, grads=_by_name(grads), roi_grads=_by_name(roi_grads))

    port = GeneralizedRCNN(**TINY).train()
    load_from_jax(port, params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rcnn, "sampling_priorities", Priorities(priorities))
        targets = DetTargets(*(torch.from_numpy(a) for a in (labels, boxes, valid)))
        got = port(t(images), torch.from_numpy(SIZES), targets, torch.from_numpy(masks))
        deltas = port.rpn.anchor_deltas.weight
        roi_grad = torch.autograd.grad(sum(got[k] for k in ROI_KEYS), deltas, retain_graph=True)[0]
        sum(got.values()).backward()
    return dict(want=want, got={k: float(v.detach()) for k, v in got.items()}, roi_grad=roi_grad.numpy(), port=port,
                params=params)


def test_train_losses_match_jax(tiny):
    want, got = tiny["want"]["losses"], tiny["got"]
    assert list(got) == ["loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask"]   # JAX's order
    assert set(want) == set(got)
    for k, v in want.items():
        assert abs(got[k] - v) <= TOL_LOSS * abs(v), (k, got[k], v)


def test_every_gradient_matches_jax(tiny):
    want, port = tiny["want"], tiny["port"]
    got = {n: p.grad.numpy() for n, p in port.named_parameters()}
    assert set(got) == set(want["grads"])
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want["grads"].values()))
    errs = {n: np.linalg.norm(g - want["grads"][n]) / (TOL_GRAD * np.linalg.norm(want["grads"][n]) + GRAD_FLOOR * norm)
            for n, g in got.items()}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert worst[0][1] <= 1.0, worst


def test_roi_losses_reach_the_rpn_deltas(tiny):
    """The proposals are not detached (as in JAX): the ROI losses' gradient on
    ``rpn.anchor_deltas`` is nonzero in both packages, and equal."""
    want = tiny["want"]["roi_grads"]["rpn.anchor_deltas.weight"]
    got = tiny["roi_grad"]
    assert np.linalg.norm(want) > 0 and np.linalg.norm(got) > 0
    assert np.linalg.norm(got - want) <= TOL_GRAD * np.linalg.norm(want) + 1e-7


def test_rpn_losses_match_jax():
    """``RPN.losses`` on the same logits, deltas, anchors and targets at JAX's
    priorities: the matches, labels and sampled anchors equal (fewer
    foreground anchors than the 128 slots, so the non-members' ties at -1 are
    taken in index order), both losses at 1e-5 relative."""
    rng = np.random.RandomState(2)
    rpn = RPN(32)
    anchors = rpn.anchors([(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)], "cpu")
    n = anchors.shape[0]
    logits, deltas = rng.randn(2, n).astype(np.float32), 0.3 * rng.randn(2, n, 4).astype(np.float32)
    labels, boxes, valid, _ = _targets(4)
    key = jax.random.PRNGKey(11)
    pri = np.asarray(jax.random.uniform(key, (2, n)))
    jt = JaxDetTargets(labels=jnp.asarray(labels), boxes=jnp.asarray(boxes), valid=jnp.asarray(valid))

    def jax_side(lg, dl, an, tg):
        idx, lab = jax.vmap(lambda g, v: jax_iou_matcher(g, v, an, thresholds=(0.3, 0.7)))(tg.boxes, tg.valid)
        fg_sel = jax.lax.top_k(jnp.where(lab == 1, pri, -1.0), 128)[1]
        bg_sel = jax.lax.top_k(jnp.where(lab == 0, pri, -1.0), 128)[1]
        return JaxRPN.losses(lg, dl, an, tg, rng=key), idx, lab, fg_sel, bg_sel

    want, w_idx, w_lab, w_fg, w_bg = jax.jit(jax_side)(logits, deltas, anchors.numpy(), jt)
    targets = DetTargets(*(torch.from_numpy(a) for a in (labels, boxes, valid)))
    idx, lab = rcnn._match(targets, anchors, (0.3, 0.7), True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(w_lab))
    assert 0 < int((lab == 1).sum(1).max()) < 128
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rcnn, "sampling_priorities", Priorities([pri]))
        fg_sel, bg_sel = rcnn._sample(lab == 1, lab == 0, 128, 128, None)
        got = RPN.losses(t(logits), t(deltas), anchors, targets)
    np.testing.assert_array_equal(fg_sel.numpy(), np.asarray(w_fg))
    np.testing.assert_array_equal(bg_sel.numpy(), np.asarray(w_bg))
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-5 * abs(float(v)), (k, float(got[k]), float(v))


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_roi_align_per_item_matches_jax(aligned):
    """Each ROI samples its own item of a bool bank (the port reads the bits;
    JAX a f32 copy): ROIs across every border, at 1e-5, as
    tests/test_torch_rcnn.py holds ``roi_align`` (JAX sums the samples'
    weights in its one-hot products, the port at the corners it gathers)."""
    rng = np.random.RandomState(9)
    bank = rng.rand(7, 30, 44) > 0.5
    x1, y1 = rng.uniform(-10, 44, 50), rng.uniform(-10, 30, 50)
    rois = np.stack([x1, y1, x1 + rng.uniform(0.5, 30, 50), y1 + rng.uniform(0.5, 20, 50)], 1).astype(np.float32)
    items = rng.randint(0, 7, 50)
    want = jax.jit(lambda b, r, i: jax_roi_align_per_item(b, r, i, (14, 14), aligned=aligned))(
        bank.astype(np.float32), rois, items)
    got = roi_align_per_item(torch.from_numpy(bank), t(rois), torch.from_numpy(items), (14, 14), aligned=aligned)
    assert got.dtype == torch.float32 and got.shape == (50, 14, 14)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert 0.1 < float(got.mean()) < 0.9


def test_solver_groups_equal_jax_masks(tiny):
    """The frozen (FrozenBN tensors, stem, layer1) and backbone sets of
    GeneralizedRCNN, equal to JAX's masks on its tree."""
    params, port = tiny["params"], tiny["port"]

    def by_name(mask):
        full = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), mask, params)
        return {n: bool(v.flat[0]) for n, v in _by_name(full).items()}

    frozen = solver.frozen_mask(port)
    assert frozen == by_name(jax_frozen_mask(params))
    assert solver.backbone_mask(port) == by_name(jax_backbone_mask(params))
    assert 10 < sum(frozen.values()) < len(frozen)


# ---------------------------------------------------------------- the solver's recipes against optax
# a flax-like tree whose paths fall in each group: the stem and layer1 frozen, layer2 the backbone's, rpn main
TOY = {"backbone": {"conv1": (3, 4), "layer1_0": (4, 4), "layer2_0": (4, 5)}, "rpn": {"conv": (5, 2)}}
RECIPES = {
    "sgd_momentum": ["SOLVER.OPTIMIZER", "SGD"],
    "sgd_nesterov_cosine": ["SOLVER.OPTIMIZER", "SGD", "SOLVER.NESTEROV", "True",
                            "SOLVER.LR_SCHEDULER_NAME", "WarmupCosineLR"],
    "sgd_clip_value": ["SOLVER.OPTIMIZER", "SGD", "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
                       "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "value", "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "0.5"],
    "adamw_cosine": ["SOLVER.LR_SCHEDULER_NAME", "WarmupCosineLR"],
}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_solver_recipe_matches_optax(recipe):
    """6 steps of the same gradients (N(0, 1), so a clip at 0.5 bites) through
    the port's optimizer, scheduler and clip and through JAX's optax chain:
    the schedule equal at every step (1e-6 relative), the trainable
    parameters at 1e-6 of their scale after each step, the frozen ones
    bit-equal; WEIGHT_DECAY 1e-4 is set, which SGD ignores on both sides."""
    opts = ["SOLVER.BASE_LR", "0.02", "SOLVER.MOMENTUM", "0.9", "SOLVER.WEIGHT_DECAY", "1e-4", "SOLVER.MAX_ITER", "6",
            "SOLVER.STEPS", "(3,)", "SOLVER.WARMUP_ITERS", "2", "SOLVER.WARMUP_FACTOR", "0.001", *RECIPES[recipe]]
    cfg, jcfg = get_cfg(), jax_get_cfg()
    add_idol_config(cfg)
    jax_add_idol_config(jcfg)
    cfg.merge_from_list(opts)
    jcfg.merge_from_list(opts)
    rng = np.random.RandomState(len(recipe))
    tree = {g: {m: {"kernel": rng.randn(*shape).astype(np.float32)} for m, shape in mods.items()}
            for g, mods in TOY.items()}
    state = params_from_jax(tree)
    model = torch.nn.Module()
    for name, value in state.items():
        owner = model
        for part in name.split(".")[:-1]:
            if not hasattr(owner, part):
                owner.add_module(part, torch.nn.Module())
            owner = getattr(owner, part)
        owner.register_parameter(name.split(".")[-1], torch.nn.Parameter(value.clone()))
    params = dict(model.named_parameters())
    assert sorted(n for n in params if solver.is_frozen(n)) == ["backbone.conv1.weight", "backbone.layer1_0.weight"]
    optimizer = solver.build_optimizer(cfg, model)
    scheduler = solver.build_lr_scheduler(cfg, optimizer)
    clip = solver.build_grad_clip(cfg)
    assert (clip is None) == (recipe != "sgd_clip_value")
    assert isinstance(optimizer, torch.optim.SGD if recipe.startswith("sgd") else torch.optim.AdamW)

    tx = jax_build_optimizer(jcfg, tree)
    jstep = jax.jit(lambda p, s, g: (lambda u, s2: (optax.apply_updates(p, u), s2))(*tx.update(g, s, p)))
    jparams, jstate = jax.tree.map(jnp.asarray, tree), tx.init(tree)
    schedule, jschedule = solver.build_lr_schedule(cfg), jax_lr_schedule(jcfg)
    for step in range(6):
        assert schedule(step) == pytest.approx(float(jschedule(step)), rel=1e-6), step
        assert optimizer.param_groups[1]["lr"] == pytest.approx(float(jschedule(step)), rel=1e-6), step
        grads = {g: {m: {"kernel": rng.randn(*shape).astype(np.float32)} for m, shape in mods.items()}
                 for g, mods in TOY.items()}
        for name, g in params_from_jax(grads).items():
            params[name].grad = g.clone()
        if clip is not None:
            clip(list(model.parameters()))
        optimizer.step()
        scheduler.step()
        jparams, jstate = jstep(jparams, jstate, grads)
        want = _by_name(jparams)
        for name, p in params.items():
            if solver.is_frozen(name):
                assert torch.equal(p.detach(), state[name]) and np.array_equal(want[name], state[name].numpy())
            else:
                np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                           atol=1e-6 * np.abs(want[name]).max(), err_msg=f"{name} step {step}")
    assert schedule(7) == pytest.approx(float(jschedule(7)), rel=1e-6)


# ---------------------------------------------------------------- the data and the entry point
@pytest.fixture(scope="module")
def synthetic_coco(tmp_path_factory):
    """Both packages' "coco_synthetic_tiny" (8 images at 160x224) on the same
    files (the root the JAX catalog already has in this process, if another
    test registered it first)."""
    jax_register_synthetic_coco(root=str(tmp_path_factory.mktemp("synth") / "coco_synthetic_tiny"))
    root = os.path.dirname(JaxMetadataCatalog.get("coco_synthetic_tiny").json_file)
    register_synthetic_coco(root=root)
    return root


def _quick_cfgs(name, *opts):
    cfg, jcfg = get_cfg(), jax_get_cfg()
    add_idol_config(cfg)
    jax_add_idol_config(jcfg)
    for c in (cfg, jcfg):
        c.merge_from_file(os.path.join(QUICK, name))
        c.merge_from_list(list(opts))
    return cfg, jcfg


def test_train_loader_equals_jax_and_resumes_in_sequence(synthetic_coco):
    """The first 4 batches of the port's loader (the mapper's draws, the
    sampler, ``stack_detection_batch``) bit-equal to JAX's
    ``build_detection_train_loader`` for the same seed; a loader started at
    step 2 (the samples before it make only their draws) gives the straight
    loader's batches from the third on."""
    cfg, jcfg = _quick_cfgs("mask_rcnn_R_18_instant_test.yaml", "SEED", "7")
    want = jax_build_detection_train_loader(jcfg, seed=7)
    straight = detection.build_detection_train_loader(cfg, seed=7)
    got = [next(straight) for _ in range(4)]
    for step, batch in enumerate(got):
        jbatch = next(want)
        assert sorted(batch) == sorted(jbatch) == ["boxes", "image", "image_id", "labels", "masks", "size", "valid"]
        assert batch["image_id"] == jbatch["image_id"], step
        for k, v in jbatch.items():
            if k != "image_id":
                assert batch[k].dtype == v.dtype and np.array_equal(batch[k], v), (step, k)
    assert got[0]["valid"].any() and got[0]["masks"].any()
    samples = [{k: (v[i] if k != "image_id" else v[i]) for k, v in got[0].items()} for i in range(2)]
    for a, b in ((stack_detection_batch(samples), jax_stack_detection_batch(samples)),):
        assert a["image_id"] == b["image_id"] and all(np.array_equal(a[k], b[k]) for k in a if k != "image_id")
    resumed = detection.build_detection_train_loader(cfg, seed=7, start_iter=2)
    for step in (2, 3):
        batch = next(resumed)
        assert all(np.array_equal(batch[k], got[step][k]) for k in batch), step


def _assert_same_state(a, b):
    """Two trainers' model, optimizer and scheduler states, bit for bit."""
    ma, mb = a.state.model.state_dict(), b.state.model.state_dict()
    assert list(ma) == list(mb) and all(torch.equal(ma[k], mb[k]) for k in ma)
    oa, ob = a.state.optimizer.state_dict(), b.state.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"] and sorted(oa["state"]) == sorted(ob["state"])
    for i, sa in oa["state"].items():
        assert sorted(sa) == sorted(ob["state"][i])
        assert all(torch.equal(torch.as_tensor(v), torch.as_tensor(ob["state"][i][k])) for k, v in sa.items()), i
    assert a.state.scheduler.state_dict() == b.state.scheduler.state_dict()


@pytest.fixture(scope="module")
def two_images(synthetic_coco, tmp_path_factory):
    """A 2-image synthetic COCO set for the evaluations after training (the
    quick schedules' 8-image set trains)."""
    register_synthetic_coco("coco_synthetic_two", root=str(tmp_path_factory.mktemp("synth") / "two"), num_images=2)
    return "coco_synthetic_two"


@pytest.mark.parametrize("config, resume", [("mask_rcnn_R_18_instant_test.yaml", False),
                                            ("faster_rcnn_R_18_instant_test.yaml", True)],
                         ids=["mask_rcnn", "faster_rcnn_sgd_resumed"])
def test_train_net_trains_and_resumes(two_images, tmp_path, config, resume):
    """``train_net.main`` trains the quick schedule 3 iterations on the
    synthetic COCO set: every loss finite, the final loss under
    ``TEST.FINAL_LOSS_BOUND``, the evaluation after training held to
    ``TEST.EXPECTED_RESULTS`` (bbox, and segm for Mask R-CNN), checkpoints
    written. Faster R-CNN trains with the COCO yamls' SGD (momentum 0.9; the
    quick schedules keep the defaults' AdamW), and ``--resume`` from its
    checkpoint after 2 steps runs the third step and ends bit-equal to the
    straight run: the model, the momentum buffers and the scheduler. (The
    resumed run's one step is no median, so the bound is the straight run's
    to hold: at random weights the quick schedule's third step reads ~90,
    after a step at the full rate of 1e-3, while the median of three is ~6.6.)"""
    base = ["--config-file", os.path.join(QUICK, config), "MODEL.DEVICE", "cpu",
            *(["SOLVER.OPTIMIZER", "SGD", "SOLVER.CHECKPOINT_PERIOD", "2"] if resume else [])]
    out = tmp_path / "straight"
    trainer = train_net.main([*base, "DATASETS.TEST", f"('{two_images}',)", "OUTPUT_DIR", str(out)])
    assert trainer.iter == 3 and trainer.state.step == 3
    keys = ["loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"] + (["loss_mask"] if "mask" in config else [])
    assert sorted(k for k in trainer.storage.histories() if k.startswith("loss_")) == sorted(keys)
    for k in keys + ["total_loss"]:
        assert np.isfinite(trainer.storage.history(k).values()).all(), k
    assert isinstance(trainer.state.optimizer, torch.optim.SGD if resume else torch.optim.AdamW)
    assert any(f"{two_images}/bbox/AP" in line for line in (out / "metrics.json").read_text().splitlines())
    assert sorted(p.name for p in out.glob("*.pth")) == ["model_0000001.pth"] * resume + ["model_0000002.pth"]
    if not resume:
        return
    resumed_dir = tmp_path / "resumed"
    resumed_dir.mkdir()
    (resumed_dir / "model_0000001.pth").write_bytes((out / "model_0000001.pth").read_bytes())
    (resumed_dir / "last_checkpoint").write_text("model_0000001.pth")
    resumed = train_net.main(["--resume", *base, "OUTPUT_DIR", str(resumed_dir), "DATASETS.TEST", "()",
                              "TEST.FINAL_LOSS_BOUND", "0"])
    assert resumed.start_iter == 2 and resumed.iter == 3 and resumed.state.step == 3
    assert all("momentum_buffer" in s for s in resumed.state.optimizer.state.values())
    _assert_same_state(resumed, trainer)


def test_proposal_network_trains_and_refuses_to_evaluate(synthetic_coco, tmp_path):
    """ProposalNetwork through ``train_net``: a step of the RPN's two losses
    with no test set; ``--eval-only``, or training with a test set, raises:
    neither package has an evaluator for proposals. Its runner gives each
    image's proposals in the original coordinates."""
    config = ["--config-file", os.path.join(QUICK, "mask_rcnn_R_18_instant_test.yaml")]
    opts = ["MODEL.DEVICE", "cpu", "MODEL.META_ARCHITECTURE", "ProposalNetwork", "OUTPUT_DIR", str(tmp_path)]
    trainer = train_net.main([*config, *opts, "DATASETS.TEST", "()", "SOLVER.MAX_ITER", "1"])
    assert trainer.iter == 1 and set(trainer.storage.histories()) >= {"loss_rpn_cls", "loss_rpn_loc", "total_loss"}
    assert "loss_cls" not in trainer.storage.histories()
    for argv in (["--eval-only"], []):
        with pytest.raises(NotImplementedError, match="an evaluator for proposals"):
            train_net.main([*config, *argv, *opts])
    cfg, _ = _quick_cfgs("mask_rcnn_R_18_instant_test.yaml", "MODEL.META_ARCHITECTURE", "ProposalNetwork")
    runner = detection.DetectionInference(cfg, trainer.state.model.eval())
    record = DatasetCatalog.get("coco_synthetic_tiny")[0]
    out = runner(record)
    assert sorted(out) == ["objectness_logits", "proposal_boxes"]
    assert out["proposal_boxes"].shape == (cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN, 4)
    # the image (160x224) is served at 128x179: the boxes come back scaled by 1.25
    assert out["proposal_boxes"][:, 2].max() <= record["width"] + 1e-3 and out["proposal_boxes"][:, 2].max() > 179
