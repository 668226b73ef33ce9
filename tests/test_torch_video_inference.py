"""The port's whole-video IDOL inference against the JAX package's, on the CPU.

One random flax parameter tree drives the JAX ``IDOLVideoInference`` and, through
the weight bridge, the port's, over a 12-frame synthetic video at 64x85 padded
to 64x96 in clips of 5 (so the last clip is padded). Tracks and labels must be
equal, scores close, masks agree on >= 99.9% of pixels, and the results.json
entries match. The two host trackers, fed identical numpy outputs, must give
identical ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.engine.vis_inference import IDOLVideoInference as JaxVideoInference
from vnext_tpu.evaluation.rle import rle_decode
from vnext_tpu.evaluation.ytvis_eval import video_output_to_json as jax_to_json
from vnext_tpu.models.idol import IDOL as JaxIDOL
from vnext_tpu.tracking.idol_tracker import IDOLTracker as JaxTracker
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.engine.vis_inference import IDOLVideoInference
from vnext_tpu_torch.evaluation.ytvis_json import video_output_to_json
from vnext_tpu_torch.models.idol import IDOL
from vnext_tpu_torch.tracking.idol_tracker import IDOLTracker

from _tiny_idol import H, W, make_model
from _torch_helpers import TINY_IDOL, random_params

torch.set_num_threads(2)

VIDEO_H, VIDEO_W, N_FRAMES, CLIP = 64, 85, 12, 5
RUNNER = dict(test_short_edge=64, test_max_size=96, target_size=(H, W), batch_infer_len=CLIP)


def _video(seed):
    """uint8 frames: three coloured rectangles moving over a dark background."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 30, (N_FRAMES, VIDEO_H, VIDEO_W, 3)).astype(np.uint8)
    for o in range(3):
        y, x = rng.randint(0, 30), rng.randint(0, 50)
        vy, vx = rng.randint(-2, 3), rng.randint(-2, 3)
        color = rng.randint(60, 256, 3)
        for i in range(N_FRAMES):
            y0, x0 = np.clip(y + vy * i, 0, VIDEO_H - 1), np.clip(x + vx * i, 0, VIDEO_W - 1)
            frames[i, y0:y0 + 20, x0:x0 + 25] = color
    return frames


@pytest.fixture(scope="module")
def both_outputs():
    frames = _video(3)
    record = {"video_id": 7, "height": VIDEO_H, "width": VIDEO_W, "length": N_FRAMES,
              "file_names": [f"{i}.jpg" for i in range(N_FRAMES)]}
    loader = lambda path: frames[int(path[:-4])]                               # noqa: E731

    jmodel = make_model()
    x, s = jnp.zeros((CLIP, H, W, 3)), jnp.asarray([[VIDEO_H, VIDEO_W]] * CLIP, jnp.int32)
    params = random_params(
        lambda: jmodel.init(jax.random.PRNGKey(0), x, s, method=JaxIDOL.inference), seed=5)
    want = JaxVideoInference(jmodel, params, image_loader=loader, **RUNNER)(record)

    port = IDOL(**TINY_IDOL, dtype=torch.float32).eval()
    load_from_jax(port, params)
    got = IDOLVideoInference(port, image_loader=loader, **RUNNER)(record)
    return got, want


def _mask_agreement(a, b):
    a, b = np.asarray(a, bool), np.asarray(b, bool)
    return float((a == b).mean())


def test_tracks_labels_scores_masks(both_outputs):
    got, want = both_outputs
    assert got["image_size"] == tuple(want["image_size"]) == (VIDEO_H, VIDEO_W)
    assert len(want["pred_labels"]) > 0, "the video must produce tracks"
    assert got["pred_labels"] == want["pred_labels"]
    # f32 on both sides: scores are sigmoids of logits that agree to ~1e-5
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], atol=1e-4, rtol=0)
    assert len(got["pred_masks"]) == len(want["pred_masks"])
    for inst_g, inst_w in zip(got["pred_masks"], want["pred_masks"]):
        assert [m is None for m in inst_g] == [m is None for m in inst_w]
        for mg, mw in zip(inst_g, inst_w):
            if mw is not None:
                assert mg.shape == mw.shape == (VIDEO_H, VIDEO_W)
                # a pixel can flip only where the probability sits at 0.5 to f32 rounding
                assert _mask_agreement(mg, mw) >= 0.999


def test_results_json_entries(both_outputs):
    got, want = both_outputs
    eg, ew = video_output_to_json(got, 7), jax_to_json(want, 7)
    assert len(eg) == len(ew) > 0
    for a, b in zip(eg, ew):
        assert (a["video_id"], a["category_id"]) == (b["video_id"], b["category_id"])
        assert abs(a["score"] - b["score"]) <= 1e-4
        assert len(a["segmentations"]) == len(b["segmentations"]) == N_FRAMES
        for sa, sb in zip(a["segmentations"], b["segmentations"]):
            assert sa["size"] == sb["size"] == [VIDEO_H, VIDEO_W]
            assert _mask_agreement(rle_decode(sa), rle_decode(sb)) >= 0.999


def _detections(seed, t_frames=10, n=8, e=8, hw=16):
    rng = np.random.RandomState(seed)
    obj = rng.randn(4, e).astype(np.float32) * 3
    frames = []
    for _ in range(t_frames):
        which = rng.randint(0, 4, size=n)
        boxes = np.concatenate([rng.rand(n, 4) * 0.5 + 0.25, rng.rand(n, 1)], 1).astype(np.float32)
        masks = np.full((n, hw, hw), -8.0, np.float32)
        for i, w in enumerate(which):
            cy, cx = (w // 2) * hw // 2, (w % 2) * hw // 2
            sz = 4 + rng.randint(0, 4)
            masks[i, cy:cy + sz, cx:cx + sz] = 8.0
        embeds = obj[which] + 0.3 * rng.randn(n, e).astype(np.float32)
        frames.append((boxes, rng.randint(0, 5, n), masks, embeds))
    return frames


@pytest.mark.parametrize("seed", [0, 1])
def test_trackers_give_identical_ids(seed):
    kw = dict(init_score_thr=0.2, obj_score_thr=0.1, nms_thr_pre=0.5, nms_thr_post=0.05,
              addnew_score_thr=0.2, memo_tracklet_frames=10, memo_momentum=0.8, long_match=True,
              frame_weight=True, temporal_weight=True, memory_len=3)
    ours, theirs = IDOLTracker(**kw), JaxTracker(**kw)
    n_ids = 0
    for fid, (boxes, labels, masks, embeds) in enumerate(_detections(seed)):
        idx = list(range(len(boxes)))
        _, _, ids_a, kept_a = ours.match(boxes, labels, masks, embeds, fid, idx)
        _, _, ids_b, kept_b = theirs.match(boxes, labels, masks, embeds, fid, idx)
        np.testing.assert_array_equal(ids_a, ids_b)
        assert kept_a == kept_b
        n_ids += int((ids_a >= 0).sum())
    assert n_ids > 0
