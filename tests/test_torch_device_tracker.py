"""The port's on-device IDOL tracker and fused runner path against the JAX package's, on the CPU.

- ``tracker_step`` over the random multi-frame episodes of
  tests/test_device_tracker.py (4 seeds, the bisoftmax and cosine metrics,
  and the fused runner's setting: long-term memory with frame and temporal
  weights, memory 3, momentum 0.8): ids and keeps equal frame by frame, and
  every state leaf after every frame equal (integers and bools exactly, floats
  within rtol 1e-6 / atol 1e-7: the same f32 formulas, reduced in other
  orders). Births beyond capacity are dropped in both.
- ``_mask_iou``, ``_mask_nms_keep`` and ``_masked_softmax`` on their own.
- ``batched_nms_mask`` on random boxes with classes, a validity mask and tied
  scores: the keep masks equal.
- The fused path: the port's ``fused_track_video`` against JAX's on the whole-
  video outputs of tests/test_fused_tracker_path.py (12 frames in clips of
  5, the last one short): the per-frame (query, track id) pairs equal; and
  against the port's host tracker (``_assemble_video``): the same video dict
  (labels, scores within rtol 1e-5, every mask), whose capacities (24
  tracklets, 12 detections) do not bind there.
- The serving loop (``_run_clips_fused``, what ``__call__`` runs) on the
  same outputs, fed clip by clip with the last clip padded: the same pairs as
  ``fused_track_video`` and JAX's, and the real frames' outputs returned.
- The host NMS keeps exact score ties in index order (a stable sort, as the
  fused path's), past the length where numpy's default sort is not stable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.engine.vis_inference import IDOLVideoInference as JaxRunner
from vnext_tpu.ops import nms as jax_nms
from vnext_tpu.tracking import idol_tracker_device as jdt
from vnext_tpu_torch.engine.vis_inference import IDOLVideoInference, _nms_numpy
from vnext_tpu_torch.ops import nms
from vnext_tpu_torch.tracking import idol_tracker_device as dt

from test_device_tracker import KW, _episode
from test_fused_tracker_path import _make_outputs

FUSED_KW = dict(KW, memo_tracklet_frames=10, long_match=True, frame_weight=True, temporal_weight=True)


def _leaves_equal(got: dt.TrackerState, want: jdt.TrackerState, where):
    for name in dt.TrackerState._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, (where, name)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=f"{where} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {name}")


@pytest.mark.parametrize("seed", [0, 1, 2, 7])
@pytest.mark.parametrize("kw", [dict(KW, match_metric="bisoftmax"), dict(KW, match_metric="cosine"), FUSED_KW],
                         ids=["bisoftmax", "cosine", "fused-runner"])
def test_tracker_step_matches_jax(seed, kw):
    frames = _episode(seed)
    nd, c = frames[0][3].shape
    memory = 3 if kw.get("long_match") else 1
    jstate = jdt.init_state(capacity=16, num_dets=nd, embed_dim=c, memory_len=memory)
    state = dt.init_state(capacity=16, num_dets=nd, embed_dim=c, memory_len=memory)
    valid = np.ones(nd, bool)
    valid[-1] = seed % 2 == 0                       # a padded detection in odd seeds
    for fid, (boxes, labels, masks, embeds) in enumerate(frames):
        jstate, jids, jkeep = jdt.tracker_step(
            jstate, jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(masks) > 0, jnp.asarray(embeds),
            jnp.asarray(valid), jnp.asarray(fid, jnp.int32), **kw)
        state, ids, keep = dt.tracker_step(
            state, torch.from_numpy(boxes), torch.from_numpy(labels), torch.from_numpy(masks) > 0,
            torch.from_numpy(embeds), torch.from_numpy(valid), fid, **kw)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep), err_msg=f"frame {fid}")
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids), err_msg=f"frame {fid}")
        _leaves_equal(state, jstate, f"frame {fid}")
    assert int(state.num_tracklets) >= 2


def test_capacity_drop_matches_jax():
    """Six births into two slots: every detection gets an id, two slots keep theirs."""
    nd, c = 6, 8
    rng = np.random.RandomState(0)
    boxes = rng.rand(nd, 5).astype(np.float32)
    boxes[:, 4] = 0.9
    masks = np.full((nd, 8, 8), -8.0, np.float32)
    for i in range(nd):
        masks[i, i, :] = 8.0
    embeds = rng.randn(nd, c).astype(np.float32)
    jstate, jids, _ = jdt.tracker_step(jdt.init_state(2, nd, c), jnp.asarray(boxes), jnp.zeros(nd, jnp.int32),
                                       jnp.asarray(masks) > 0, jnp.asarray(embeds), jnp.ones(nd, bool),
                                       jnp.asarray(0, jnp.int32), **KW)
    state, ids, _ = dt.tracker_step(dt.init_state(2, nd, c), torch.from_numpy(boxes), torch.zeros(nd, dtype=torch.int32),
                                    torch.from_numpy(masks) > 0, torch.from_numpy(embeds), torch.ones(nd, dtype=torch.bool),
                                    0, **KW)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert int((ids >= 0).sum()) == 6 and int((state.slot_tid >= 0).sum()) == 2
    _leaves_equal(state, jstate, "capacity")


def test_helpers_match_jax():
    rng = np.random.RandomState(3)
    masks = rng.rand(9, 12, 10) > 0.6
    masks[4] = masks[2]                                  # an exact duplicate is suppressed
    valid = np.ones(9, bool)
    valid[7] = False
    np.testing.assert_allclose(dt._mask_iou(torch.from_numpy(masks), torch.from_numpy(masks[:5])).numpy(),
                               np.asarray(jdt._mask_iou(jnp.asarray(masks), jnp.asarray(masks[:5]))), rtol=1e-7)
    for thr in (0.2, 0.35, 0.5):
        got = dt._mask_nms_keep(torch.from_numpy(masks), torch.from_numpy(valid), thr).numpy()
        np.testing.assert_array_equal(got, np.asarray(jdt._mask_nms_keep(jnp.asarray(masks), jnp.asarray(valid), thr)))
    assert not dt._mask_nms_keep(torch.from_numpy(masks), torch.from_numpy(valid), 0.99)[4]
    x = rng.randn(5, 7).astype(np.float32)
    ok = rng.rand(5, 7) > 0.4
    ok[1] = False                                        # a row with nothing valid
    for axis in (0, 1):
        np.testing.assert_allclose(dt._masked_softmax(torch.from_numpy(x), torch.from_numpy(ok), axis).numpy(),
                                   np.asarray(jdt._masked_softmax(jnp.asarray(x), jnp.asarray(ok), axis)),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_nms_mask_matches_jax(seed):
    rng = np.random.RandomState(seed)
    n = 40
    xy = rng.rand(n, 2).astype(np.float32) * 0.6
    boxes = np.concatenate([xy, xy + 0.1 + rng.rand(n, 2).astype(np.float32) * 0.3], 1)
    boxes[5] = boxes[3]                                  # duplicates, one of another class
    boxes[6] = boxes[3]
    scores = rng.rand(n).astype(np.float32)
    scores[10:14] = scores[2]                            # ties toward the lower index
    cls = rng.randint(0, 3, n)
    cls[6] = (cls[3] + 1) % 3
    valid = rng.rand(n) > 0.2
    for thr in (0.3, 0.7, 0.9):
        want = jax_nms.batched_nms_mask(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls), thr,
                                        valid=jnp.asarray(valid))
        got = nms.batched_nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(cls), thr,
                                   valid=torch.from_numpy(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"thr {thr}")
        np.testing.assert_array_equal(nms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr).numpy(),
                                      np.asarray(jax_nms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thr)))
    assert nms.batched_nms_mask(torch.zeros(0, 4), torch.zeros(0), torch.zeros(0), 0.5).shape == (0,)


def _runners(**kw):
    args = dict(batch_infer_len=5, target_size=(16, 16), fused_capacity=24, fused_dets=12, **kw)
    return JaxRunner(None, None, fused_tracker=True, **args), IDOLVideoInference(torch.nn.Linear(1, 1), **args)


@pytest.mark.parametrize("seed", [0, 4])
def test_fused_track_video_matches_jax_and_the_host_tracker(seed):
    outputs = _make_outputs(seed)
    jrunner, runner = _runners()
    want = jrunner.fused_track_video(outputs)
    got = runner.fused_track_video(outputs)
    assert len(got) == len(want) == len(outputs["pred_logits"])
    assert got == want
    assert sum(len(f) for f in got) > 10

    ori, size = (64, 64), (16, 16)
    ref = runner._assemble_video(outputs, runner.make_tracker(), ori, size)
    dict_ = runner._build_video_dict(outputs, got, ori, size)
    assert dict_["pred_labels"] == ref["pred_labels"] and len(ref["pred_labels"]) > 0
    np.testing.assert_allclose(dict_["pred_scores"], ref["pred_scores"], rtol=1e-5)
    assert len(dict_["pred_masks"]) == len(ref["pred_masks"])
    for gm, rm in zip(dict_["pred_masks"], ref["pred_masks"]):
        assert len(gm) == len(rm)
        for a, b in zip(gm, rm):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 4])
def test_served_path_matches_fused_track_video(seed):
    """12 frames in clips of 5: the third clip holds 2 real frames and 3 of
    padding, whose outputs (random here) must not reach the tracker."""
    outputs = _make_outputs(seed)
    jrunner, runner = _runners()
    cl, t = runner.batch_infer_len, len(outputs["pred_logits"])
    rng = np.random.RandomState(seed)
    padded = {k: np.concatenate([v, rng.randn(-t % cl, *v.shape[1:]).astype(np.float32)])
              for k, v in outputs.items()}
    starts = []

    def forward_clip(chunk, size):
        c = len(starts) * cl
        starts.append(c)
        assert chunk.shape[0] == cl
        return {k: torch.from_numpy(v[c:c + cl]) for k, v in padded.items()}

    runner.forward_clip = forward_clip
    got_outputs, got = runner._run_clips_fused(np.zeros((t, 16, 16, 3), np.uint8), (16, 16))
    assert starts == [0, 5, 10]
    for k, v in outputs.items():
        np.testing.assert_array_equal(got_outputs[k], v, err_msg=k)
    assert len(got) == t
    assert got == runner.fused_track_video(outputs) == jrunner.fused_track_video(outputs)


def test_host_nms_keeps_ties_in_index_order():
    """40 candidates in overlapping pairs (2i, 2i + 1) of one score, the pairs
    at two scores in turn: each pair keeps its lower index, and the kept list
    holds the higher score's pairs first, each score's in index order."""
    n = 40
    xy = np.repeat(np.arange(n // 2, dtype=np.float32)[:, None] * 10, 2, 0).repeat(2, 1)
    boxes = np.concatenate([xy, xy + 5], 1)
    boxes[1::2, 2:] += 0.1                                # IoU ~0.96 within a pair
    scores = np.where(np.arange(n) // 2 % 2 == 0, 0.5, 0.25).astype(np.float32)
    keep = _nms_numpy(boxes, scores, np.zeros(n, np.int64), 0.9)
    np.testing.assert_array_equal(keep, np.concatenate([np.arange(0, n, 4), np.arange(2, n, 4)]))
