"""The port's SeqFormer video inference against the JAX package's, on the CPU.

- ``VideoStitcher`` against the JAX one on the cases of
  tests/test_seqformer_inference.py (linking, a new instance, no false merge);
- the top-10 query selection, made on the card in the port, against the JAX
  runner's ``np.argsort(-cls.max(1))[:10]`` on the same logits;
- ``SeqFormerVideoInference`` whole-video and clip-matched against the JAX
  runner on one synthetic 8-frame video at 64x85 (padded to 64x96), with one
  random flax tree bridged to a tiny SeqFormer: the same instances and labels,
  scores within 1e-4, masks equal but for at most 0.1% of pixels (a pixel flips
  only where its probability sits at 0.5 to f32 rounding);
- ``from_config`` reads the keys ``demo/demo.py`` reads.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.engine.seqformer_inference import SeqFormerVideoInference as JaxRunner
from vnext_tpu.engine.seqformer_inference import VideoStitcher as JaxStitcher
from vnext_tpu.models.seqformer import SeqFormer as JaxSeqFormer
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.engine.seqformer_inference import (SeqFormerVideoInference, VideoStitcher,
                                                        seqformer_runner_kwargs_from_cfg, topk_queries)
from vnext_tpu_torch.models.seqformer import SeqFormer

from _torch_helpers import random_params

torch.set_num_threads(2)

H, W = 64, 96
VIDEO_H, VIDEO_W, N_FRAMES = 64, 85, 8
TINY = dict(num_classes=5, hidden_dim=32, num_queries=12, nheads=4, dim_feedforward=64,
            enc_layers=1, dec_layers=2)
RUNNER = dict(test_short_edge=64, test_max_size=96, target_size=(H, W))


def _mask_logit(h, w, y0, y1, x0, x1):
    m = np.full((h, w), -10.0, np.float32)
    m[y0:y1, x0:x1] = 10.0
    return m


def _stitch_cases():
    a4 = [_mask_logit(16, 16, 2, 8, 2, 8) for _ in range(4)]
    b4 = [_mask_logit(16, 16, 10, 15, 10, 15) for _ in range(4)]
    cls2 = np.asarray([[0.9, 0.1, 0.0], [0.0, 0.8, 0.1]], np.float32)
    both = np.stack([np.stack(a4), np.stack(b4)])
    a = np.stack([_mask_logit(8, 8, 0, 4, 0, 4)] * 2)
    b = np.stack([_mask_logit(8, 8, 4, 8, 4, 8)] * 2)
    c = np.stack([_mask_logit(8, 8, 5, 8, 5, 8)] * 2)
    return {
        "links_overlapping_clips": ((6, 3, (16, 16)), [([0, 1, 2, 3], cls2, both), ([2, 3, 4, 5], cls2, both)]),
        "new_instance_in_later_clip": ((4, 2, (8, 8)), [
            ([0, 1], np.asarray([[0.9, 0.0]], np.float32), a[None]),
            ([1, 2], np.asarray([[0.9, 0.0], [0.0, 0.9]], np.float32), np.stack([a, b]))]),
        "no_false_merge": ((4, 2, (8, 8)), [
            ([0, 1], np.asarray([[0.9, 0.0]], np.float32), a[None]),
            ([1, 2], np.asarray([[0.8, 0.0]], np.float32), c[None])]),
    }


@pytest.mark.parametrize("case", list(_stitch_cases()))
def test_stitcher_matches_jax(case):
    args, updates = _stitch_cases()[case]
    ours, theirs = VideoStitcher(*args), JaxStitcher(*args)
    for frame_idx, cls, masks in updates:
        ours.update(frame_idx, cls, masks)
        theirs.update(frame_idx, cls, masks)
        assert ours.num_inst == theirs.num_inst
    for g, w in zip(ours.get_result(), theirs.get_result()):
        np.testing.assert_array_equal(g, w)
    assert ours.num_inst == {"links_overlapping_clips": 2, "new_instance_in_later_clip": 2,
                             "no_false_merge": 2}[case]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_picks_the_jax_runners_queries(seed):
    logits = np.random.RandomState(seed).randn(300, 40).astype(np.float32) * 3.0
    runner = JaxRunner.__new__(JaxRunner)
    runner.topk = 10
    want_cls, want_idx = runner._select_topk(logits, np.arange(300))
    got = topk_queries(torch.from_numpy(logits), 10).numpy()
    np.testing.assert_array_equal(got, want_idx)
    np.testing.assert_array_equal(got, np.argsort(-(1 / (1 + np.exp(-logits))).max(1))[:10])


def _video(seed):
    """uint8 frames: three coloured rectangles moving over a dark background."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 30, (N_FRAMES, VIDEO_H, VIDEO_W, 3)).astype(np.uint8)
    for _ in range(3):
        y, x = rng.randint(0, 30), rng.randint(0, 50)
        vy, vx = rng.randint(-2, 3), rng.randint(-2, 3)
        color = rng.randint(60, 256, 3)
        for i in range(N_FRAMES):
            y0, x0 = np.clip(y + vy * i, 0, VIDEO_H - 1), np.clip(x + vx * i, 0, VIDEO_W - 1)
            frames[i, y0:y0 + 20, x0:x0 + 25] = color
    return frames


@pytest.fixture(scope="module")
def setup():
    frames = _video(4)
    record = {"video_id": 3, "height": VIDEO_H, "width": VIDEO_W, "length": N_FRAMES,
              "file_names": [f"{i}.jpg" for i in range(N_FRAMES)]}
    loader = lambda path: frames[int(path[:-4])]                               # noqa: E731
    jmodel = JaxSeqFormer(**TINY, msda_impl="jnp")
    x, s = jnp.zeros((1, 3, H, W, 3)), jnp.asarray([[VIDEO_H, VIDEO_W]], jnp.int32)
    params = random_params(
        lambda: jmodel.init(jax.random.PRNGKey(0), x, s, method=JaxSeqFormer.inference), seed=7)
    port = SeqFormer(**TINY, dtype=torch.float32).eval()
    load_from_jax(port, params)
    return record, loader, jmodel, params, port


def _mask_agreement(a, b):
    return float((np.asarray(a, bool) == np.asarray(b, bool)).mean())


@pytest.mark.parametrize("clip_matching", [False, True], ids=["whole_video", "clip_matched"])
def test_video_inference_matches_jax(setup, clip_matching):
    record, loader, jmodel, params, port = setup
    kw = dict(clip_matching=clip_matching, clip_length=3, clip_stride=1, image_loader=loader, **RUNNER)
    want = JaxRunner(jmodel, params, **kw)(record)
    got = SeqFormerVideoInference(port, **kw)(record)
    assert got["image_size"] == tuple(want["image_size"]) == (VIDEO_H, VIDEO_W)
    assert len(want["pred_labels"]) > 0, "the video must produce instances"
    assert got["pred_labels"] == want["pred_labels"]
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], atol=1e-4, rtol=0)
    assert len(got["pred_masks"]) == len(want["pred_masks"])
    for inst_g, inst_w in zip(got["pred_masks"], want["pred_masks"]):
        assert [m is None for m in inst_g] == [m is None for m in inst_w]
        assert len(inst_g) == N_FRAMES
        for mg, mw in zip(inst_g, inst_w):
            if mw is not None:
                assert mg.shape == mw.shape == (VIDEO_H, VIDEO_W)
                assert _mask_agreement(mg, mw) >= 0.999


def test_from_config_reads_the_demos_keys():
    from vnext_tpu.config import add_seqformer_config, get_cfg

    cfg = get_cfg()
    add_seqformer_config(cfg)
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs", "seqformer", "ytvis19_r50.yaml"))
    cfg.MODEL.SeqFormer.CLIP_MATCHING = True
    cfg.MODEL.SeqFormer.CLIP_STRIDE = 2
    kw = seqformer_runner_kwargs_from_cfg(cfg)
    assert (kw["clip_matching"], kw["clip_length"], kw["clip_stride"]) == (True, 5, 2)
    assert kw["target_size"] == (480, 864) and kw["test_short_edge"] == 480
    defaults = {k: p.default for k, p in inspect.signature(SeqFormerVideoInference.__init__).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert defaults["clip_length"] == kw["clip_length"] and defaults["topk"] == 10
    runner = SeqFormerVideoInference.from_config(cfg, SeqFormer(**TINY))
    assert (runner.clip_matching, runner.clip_length, runner.clip_stride) == (True, 5, 2)
