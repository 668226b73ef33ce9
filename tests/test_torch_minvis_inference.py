"""The port's MinVIS whole-video inference against the JAX package's, on the CPU in f32.

One random flax tree drives the JAX ``MinVISVideoInference`` and, through the
weight bridge, the port's, on the tiny MaskFormer of tests/test_mask2former.py
and a synthetic video as tests/test_mask2former.py's runner test makes one
(4 frames at 100x140, windows of 2). Labels must be equal, scores within 1e-5
(means of f32 softmaxes of logits that agree to ~1e-5) and each mask agree on
>= 99.9% of pixels (a pixel whose upsampled logit is within f32 noise of 0 may
flip). With the tiny InstMove predictor the motion-fused runner runs where JAX
runs (128x128 frames, 32x32 masks: multiples of 16) and must give JAX's result;
at 90x160 masks both packages fail, the port with a ``ValueError``. The
frame-to-frame matching returns JAX's permutation with and without the motion
cost.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.data.synthetic import make_image_loader, make_synthetic_videos
from vnext_tpu.engine.minvis_inference import MinVISVideoInference as JaxMinVIS
from vnext_tpu.models.instmove import InstMovePredictor as JaxInstMove
from vnext_tpu.models.mask2former import MaskFormer as JaxMaskFormer
from vnext_tpu.models.mask2former import minvis_match_from_embds as jax_match
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.engine.minvis_inference import MinVISVideoInference
from vnext_tpu_torch.evaluation.ytvis_json import video_output_to_json
from vnext_tpu_torch.models.instmove import InstMovePredictor
from vnext_tpu_torch.models.mask2former import MaskFormer, minvis_match_from_embds

from _torch_helpers import random_params

torch.set_num_threads(2)

NQ = 8
TINY = dict(num_classes=5, hidden_dim=32, num_queries=NQ, dec_layers=3, enc_layers=1, dim_feedforward=64)
TINY_MOTION = dict(memory_size=8, num_lstm_layers=2, lstm_channels=16)


def _maskformers(h, w, seed):
    jmodel = JaxMaskFormer(**TINY, msda_impl="jnp")
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)),
                                               jnp.asarray([[h, w]], jnp.int32),
                                               method=JaxMaskFormer.inference), seed=seed)
    port = MaskFormer(**TINY, dtype=torch.float32).eval()
    load_from_jax(port, params)
    return jmodel, params, port


def _assert_same_video(got, want):
    assert got["image_size"] == tuple(want["image_size"])
    assert got["pred_labels"] == want["pred_labels"]
    np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], rtol=0, atol=1e-5)
    assert len(got["pred_masks"]) == len(want["pred_masks"])
    for g_inst, w_inst in zip(got["pred_masks"], want["pred_masks"]):
        assert len(g_inst) == len(w_inst)
        for g, w in zip(g_inst, w_inst):
            assert g.shape == w.shape
            assert (g == w).mean() >= 0.999


@pytest.mark.parametrize("motion", [False, True], ids=["embeddings", "with-motion"])
def test_match_from_embds_matches_jax(motion):
    rng = np.random.RandomState(11)
    q = 12
    prev, cur = rng.randn(q, 16).astype(np.float32), rng.randn(q, 16).astype(np.float32)
    kw = {}
    if motion:
        kw = {"motion_mask": rng.randn(q, 10, 12).astype(np.float32) * 3,
              "current_mask": rng.randn(q, 10, 12).astype(np.float32) * 3}
    want = jax_match(prev, cur, **kw)
    got = minvis_match_from_embds(prev, cur, **kw)
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(q))


def test_runner_matches_jax():
    h, w = 64, 96
    records, store = make_synthetic_videos(num_videos=1, length=4, height=100, width=140, max_objects=2,
                                           num_classes=5, seed=21)
    jmodel, params, port = _maskformers(h, w, seed=3)
    kw = dict(window_size=2, topk=5, test_short_edge=64, test_max_size=96, target_size=(h, w),
              image_loader=make_image_loader(store))
    want = JaxMinVIS(jmodel, params, **kw)(records[0])
    got = MinVISVideoInference(port, **kw)(records[0])
    assert len(got["pred_scores"]) == 5 and len(got["pred_masks"][0]) == 4
    assert got["pred_masks"][0][0].shape == (100, 140)
    _assert_same_video(got, want)
    entries = video_output_to_json(got, records[0]["video_id"])
    assert len(entries) == 5 and all(len(e["segmentations"]) == 4 for e in entries)


@pytest.fixture(scope="module")
def motion_models():
    side, mask_side = 128, 32
    jmotion = JaxInstMove(**TINY_MOTION)
    mparams = random_params(lambda: jmotion.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, mask_side, mask_side, 1)),
                                                 jnp.zeros((1, side, side, 3))), seed=9)
    pmotion = InstMovePredictor(**TINY_MOTION).eval()
    load_from_jax(pmotion, mparams)
    return side, jmotion, mparams, pmotion


def test_motion_fused_runner_matches_jax(motion_models):
    """6 frames at 128x128 (32x32 masks): frames 4 and 5 add the motion IoU
    cost of the predictor run on the 4 previous aligned masks and the frame.
    The predictor's masks on frame 4 are held against JAX's first (rtol 1e-4,
    atol 1e-5 of f32 sums in other orders), then the whole video."""
    side, jmotion, mparams, pmotion = motion_models
    records, store = make_synthetic_videos(num_videos=1, length=6, height=side, width=side, max_objects=3,
                                           num_classes=5, seed=5)
    jmodel, params, port = _maskformers(side, side, seed=4)
    kw = dict(window_size=3, topk=5, test_short_edge=side, test_max_size=side, target_size=(side, side),
              image_loader=make_image_loader(store))
    jrunner = JaxMinVIS(jmodel, params, motion_predictor=jmotion, motion_params=mparams, **kw)
    runner = MinVISVideoInference(port, motion_predictor=pmotion, **kw)
    calls = []
    predict = runner.predict_motion
    runner.predict_motion = lambda hist, frame: calls.append(hist.shape) or predict(hist, frame)
    want = jrunner(records[0])
    got = runner(records[0])
    assert calls == [(NQ, 4, side // 4, side // 4)] * 2
    _assert_same_video(got, want)

    rng = np.random.RandomState(12)
    hist = rng.randn(NQ, 4, side // 4, side // 4).astype(np.float32) * 4
    frame = rng.randint(0, 256, (side, side, 3)).astype(np.uint8)
    img = (frame.astype(np.float32) - jrunner.pixel_mean) / jrunner.pixel_std
    want_m = np.asarray(jrunner._motion(mparams, jnp.asarray(1 / (1 + np.exp(-hist)))[..., None],
                                        jnp.broadcast_to(jnp.asarray(img)[None], (NQ, *img.shape))))[:, 0, ..., 0]
    np.testing.assert_allclose(runner.predict_motion(hist, frame), want_m, rtol=1e-4, atol=1e-5)


def test_motion_at_90x160_masks_raises(motion_models):
    """configs/minvis/ovis_r50.yaml's 360x640 frames give 90x160 masks: the
    memory feature is 20x40 and the LSTM state 23x40. JAX fails at their
    concat; the port raises a ValueError that names both."""
    _, jmotion, mparams, pmotion = motion_models
    hist = np.zeros((NQ, 4, 90, 160), np.float32)
    frame = np.zeros((360, 640, 3), np.uint8)
    with pytest.raises(TypeError):
        jax.eval_shape(lambda: jmotion.apply({"params": mparams}, jnp.zeros((1, 4, 90, 160, 1)),
                                             jnp.zeros((1, 360, 640, 3))))
    runner = MinVISVideoInference(MaskFormer(**TINY).eval(), motion_predictor=pmotion)
    with pytest.raises(ValueError, match=r"20x40.*23x40.*multiples of 16"):
        runner.predict_motion(hist, frame)
