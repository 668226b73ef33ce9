"""The port's Mask2Former (MinVIS's frame model) against the JAX package's, on the CPU in f32.

The tiny MaskFormer of tests/test_mask2former.py (hidden 32, 8 queries, 3
decoder layers, 1 encoder layer, FFN 64, full ResNet-50, the JAX package on its
jnp MSDA path) gets one random flax tree, which the weight bridge loads into the
port with no key left over. Held against JAX: ``MultiHeadAttention`` with a
mask (and with a row that masks everything), the sine positions at offset 1.0,
the ResNet's res2..res5, the input projections level by level, the pixel
decoder's mask features and levels, every prediction's logits and masks and the
query embeddings, ``MaskFormer.inference`` whole, and MinVIS's postprocess.

On the JAX ResNet's features the input projections are held level by level,
and what follows them runs on the JAX package's projected features, as
tests/test_torch_seqformer.py does: with hidden 32 and 32 GroupNorm groups the
res5 projection's groups hold 6 values each (1 channel x 2 x 3 pixels), where
the variance cancels and the f32 summation order of the convolution comes out
of the norm amplified, in both packages alike.
"""

import inspect
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.layers import MultiHeadAttention as JaxMHA
from vnext_tpu.models.mask2former import MaskFormer as JaxMaskFormer
from vnext_tpu.models.mask2former import minvis_postprocess as jax_postprocess
from vnext_tpu.models.position_encoding import sine_position_embedding as jax_sine
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.models import mask2former as m2f
from vnext_tpu_torch.models.backbones.resnet import ResNet
from vnext_tpu_torch.models.layers import MultiHeadAttention
from vnext_tpu_torch.models.mask2former import (MaskFormer, build_maskformer_model,
                                                maskformer_kwargs_from_cfg, minvis_postprocess)
from vnext_tpu_torch.models.position_encoding import sine_position_embedding

from _torch_helpers import random_params, t

torch.set_num_threads(2)

H, W, NQ, NF = 64, 96, 8, 2
TINY = dict(num_classes=5, hidden_dim=32, num_queries=NQ, dec_layers=3, enc_layers=1, dim_feedforward=64)
# f32 on both sides, sums in other orders: elementwise rtol 1e-4, atol 1e-5
RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    images = rng.randn(NF, H, W, 3).astype(np.float32)
    sizes = jnp.asarray([[H, W]] * NF, jnp.int32)
    jmodel = JaxMaskFormer(**TINY, msda_impl="jnp")
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images), sizes,
                                               method=JaxMaskFormer.inference), seed=1)
    port = MaskFormer(**TINY, dtype=torch.float32).eval()
    load_from_jax(port, params)
    return images, jmodel, params, port


@pytest.fixture(scope="module")
def jax_stages(models):
    """The JAX package's stages on the same frames: the backbone's features,
    each input projection, the pixel decoder's outputs and ``forward_frames``."""
    images, jmodel, params, _ = models
    x = jnp.asarray(images)
    sizes = jnp.asarray([[H, W]] * NF, jnp.int32)
    feats = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, method=lambda m, x: m.backbone(x)))(params, x)
    pd = params["pixel_decoder"]
    srcs = []
    for lvl, name in enumerate(("res5", "res4", "res3")):
        y = fnn.Conv(32, (1, 1)).apply({"params": pd[f"input_proj_{lvl}"]}, feats[name])
        srcs.append(fnn.GroupNorm(num_groups=32).apply({"params": pd[f"input_norm_{lvl}"]}, y))
    mask_features, multi_scale = jax.jit(lambda p, f: jmodel.apply(
        {"params": p}, f, sizes, False, method=lambda m, f, s, tr: m.pixel_decoder(f, s, tr)))(params, feats)
    frames = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, sizes, method=JaxMaskFormer.forward_frames))(
        params, x)
    return {"feats": feats, "srcs": srcs, "mask_features": mask_features, "multi_scale": multi_scale,
            "frames": frames}


def _port_on_jax_features(port, images, stages):
    """The port's stages after the input projections, on JAX's features and projections."""
    feats = {k: t(np.asarray(v)).permute(0, 3, 1, 2) for k, v in stages["feats"].items()}
    srcs = [t(np.asarray(s)).permute(0, 3, 1, 2) for s in stages["srcs"]]
    with torch.no_grad():
        return port.forward_frames(t(images), feats=feats, srcs=srcs)


def test_bridge_covers_every_leaf(models):
    _, _, params, port = models
    state = params_from_jax(params)
    assert set(state) == set(port.state_dict())
    assert len(state) == len(jax.tree.leaves(params))
    for name in ("pixel_decoder.input_proj_0.weight", "pixel_decoder.level_embed",
                 "pixel_decoder.encoder_0.self_attn.sampling_offsets.weight", "pixel_decoder.adapter_res2.weight",
                 "pixel_decoder.mask_features.bias", "transformer_decoder.cross_2.q_proj.weight",
                 "transformer_decoder.self_0.out_proj.bias", "transformer_decoder.query_feat",
                 "transformer_decoder.dec_level_embed", "transformer_decoder.mask_embed.layers_2.weight",
                 "backbone.layer1_0.conv1.weight"):
        assert name in state, name
    assert "pixel_decoder.adapter_res2.bias" not in state and "pixel_decoder.output_conv.bias" not in state


@pytest.mark.parametrize("all_false_row", [False, True], ids=["mask", "all-false-row"])
def test_multi_head_attention_mask_matches_jax(all_false_row):
    """``where(mask, logits, -1e9)`` before the f32 softmax; a query whose row is
    all False attends uniformly (every logit -1e9), in both packages."""
    rng = np.random.RandomState(4)
    b, q, k, c, heads = 2, 5, 7, 16, 4
    qx, kx, vx = (rng.randn(b, n, c).astype(np.float32) for n in (q, k, k))
    mask = rng.rand(b, 1, q, k) < 0.6
    if all_false_row:
        mask[1, 0, 2] = False
    jmod = JaxMHA(heads)
    params = random_params(lambda: jmod.init(jax.random.PRNGKey(0), *map(jnp.asarray, (qx, kx, vx))), seed=5)
    want = jmod.apply({"params": params}, *map(jnp.asarray, (qx, kx, vx)), mask=jnp.asarray(mask))
    port = MultiHeadAttention(c, heads)
    load_from_jax(port, params)
    with torch.no_grad():
        got = port(t(qx), t(kx), t(vx), mask=torch.from_numpy(mask))
        unmasked = port(t(qx), t(kx), t(vx))
    _close(got, want)
    _close(unmasked, jmod.apply({"params": params}, *map(jnp.asarray, (qx, kx, vx))))


@pytest.mark.parametrize("offset", [0.5, 1.0])
def test_sine_position_embedding_offset_matches_jax(offset):
    vhw = np.asarray([[6, 9], [4, 9]], np.int32)
    want = jax_sine(jnp.asarray(vhw), 6, 9, num_pos_feats=16, offset=offset)
    got = sine_position_embedding(torch.from_numpy(vhw), 6, 9, num_pos_feats=16, offset=offset)
    _close(got, want, rtol=0, atol=2e-6)


def test_resnet_res2_to_res5(models, jax_stages):
    """The backbone with res2 asked for (Mask2Former's four outputs), 2e-4 of
    each output's largest magnitude as the IDOL test holds res3..res5 (f32 sums
    in other orders through 53 convolutions); a ResNet asked for res2 and res3
    alone (InstMove's) stops after them and gives the same tensors."""
    images, _, params, port = models
    with torch.no_grad():
        got = port.backbone(t(images))
        short = ResNet(50, out_features=("res2", "res3"))
        load_from_jax(short, params["backbone"])
        got_short = short(t(images))
    assert set(got) == {"res2", "res3", "res4", "res5"} and set(got_short) == {"res2", "res3"}
    for k, want in jax_stages["feats"].items():
        want = np.asarray(want)
        np.testing.assert_allclose(_nhwc(got[k]).numpy(), want, rtol=0, atol=2e-4 * np.abs(want).max())
    for k in ("res2", "res3"):
        assert torch.equal(got_short[k], got[k])


def _conv_gn_f64(x, p_conv, p_norm, groups=32, eps=1e-6):
    """An input projection (1x1 conv + GroupNorm) evaluated in f64 with numpy."""
    x = np.asarray(x, np.float64)
    y = x @ np.asarray(p_conv["kernel"], np.float64)[0, 0] + np.asarray(p_conv["bias"], np.float64)
    b, h, w, c = y.shape
    g = y.reshape(b, h * w, groups, c // groups)
    mu = g.mean((1, 3), keepdims=True)
    var = ((g - mu) ** 2).mean((1, 3), keepdims=True)
    y = ((g - mu) / np.sqrt(var + eps)).reshape(b, h, w, c)
    return y * np.asarray(p_norm["scale"], np.float64) + np.asarray(p_norm["bias"], np.float64)


@pytest.mark.parametrize("level", [0, 1, 2], ids=["res5", "res4", "res3"])
def test_input_projection_matches_jax(models, jax_stages, level):
    """Each level's input projection, coarsest first, on the JAX ResNet's
    features, against an f64 evaluation of the stage within rtol 1e-4 / atol
    1e-5 plus twice the JAX package's own f32 error there: at res5 the 2 x 3
    map gives each GroupNorm group 6 values, and the norm amplifies the f32
    summation order of the convolution (the port must be as exact as the
    reference)."""
    _, _, params, port = models
    name = ("res5", "res4", "res3")[level]
    feats = jax_stages["feats"]
    with torch.no_grad():
        got = _nhwc(port.pixel_decoder.project(
            {k: t(np.asarray(v)).permute(0, 3, 1, 2) for k, v in feats.items()})[level]).double().numpy()
    pd = params["pixel_decoder"]
    exact = _conv_gn_f64(feats[name], pd[f"input_proj_{level}"], pd[f"input_norm_{level}"])
    noise = float(np.abs(np.asarray(jax_stages["srcs"][level], np.float64) - exact).max())
    np.testing.assert_allclose(got, exact, rtol=RTOL, atol=ATOL + 2 * noise)


def test_pixel_decoder_matches_jax(models, jax_stages):
    """The deformable encoder over the 3 levels (coarsest first, every pixel
    valid, sine positions at offset 1.0) and the FPN fusion to stride 4, on
    JAX's projected features: the 3 levels and the mask features."""
    images, _, _, port = models
    got = _port_on_jax_features(port, images, jax_stages)
    assert [tuple(x.shape[1:3]) for x in got["multi_scale"]] == [(2, 3), (4, 6), (8, 12)]
    for g, w in zip(got["multi_scale"], jax_stages["multi_scale"]):
        _close(g, w)
    _close(_nhwc(got["mask_features"]), jax_stages["mask_features"])


def test_decoder_predictions_match_jax(models, jax_stages):
    """Every prediction (before the first layer and after each of the 3) on
    JAX's projected features: class logits element by element; mask logits,
    which cross zero with magnitudes of several units, to 1e-4 of their largest
    magnitude; the query embeddings element by element."""
    images, _, _, port = models
    got = _port_on_jax_features(port, images, jax_stages)
    want_logits, want_masks, want_embeds = jax_stages["frames"]
    assert len(got["logits"]) == len(want_logits) == TINY["dec_layers"] + 1
    assert len(got["attn_masks"]) == TINY["dec_layers"]
    for g, w in zip(got["logits"], want_logits):
        _close(g, w)
    for g, w in zip(got["masks"], want_masks):
        w = np.asarray(w)
        assert g.shape == (NF, NQ, H // 4, W // 4)
        _close(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    _close(got["embeds"], want_embeds)


def test_inference_with_its_own_backbone_matches_jax(models):
    """``MaskFormer.inference`` whole, ResNet-50 and projections included: 2e-4
    of each output's largest magnitude, as the IDOL and SeqFormer tests hold
    their whole paths."""
    images, jmodel, params, port = models
    sizes = jnp.asarray([[H, W]] * NF, jnp.int32)
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, sizes, method=JaxMaskFormer.inference))(
        params, jnp.asarray(images))
    with torch.no_grad():
        got = port.inference(t(images))
    assert set(got) == set(want) == {"pred_logits", "pred_masks", "pred_embds"}
    assert got["pred_logits"].shape == (NF, NQ, TINY["num_classes"] + 1)
    assert got["pred_masks"].dtype == torch.float32
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=2e-4 * max(1.0, np.abs(w).max()))


def test_minvis_postprocess_matches_jax():
    rng = np.random.RandomState(6)
    outputs = {"pred_logits": rng.randn(4, 6, 3).astype(np.float32),
               "pred_masks": rng.randn(4, 6, 5, 7).astype(np.float32),
               "pred_embds": rng.randn(4, 6, 8).astype(np.float32)}
    want = jax_postprocess(outputs)
    got = minvis_postprocess(outputs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def _ovis_r50_cfg():
    from vnext_tpu.config import get_cfg
    from vnext_tpu.config.extensions import add_maskformer_config

    cfg = get_cfg()
    add_maskformer_config(cfg)
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs", "minvis", "ovis_r50.yaml"))
    return cfg


def test_config_route_equals_defaults():
    """The constructor's defaults are MinVIS-R50 as configs/minvis/ovis_r50.yaml sets it."""
    cfg = _ovis_r50_cfg()
    kw = maskformer_kwargs_from_cfg(cfg)
    assert kw.pop("dtype") == torch.bfloat16
    defaults = {k: p.default for k, p in inspect.signature(MaskFormer.__init__).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert kw == {k: defaults[k] for k in kw}
    cfg.MODEL.RESNETS.STRIDE_IN_1X1 = True
    with pytest.raises(NotImplementedError, match="STRIDE_IN_1X1"):
        maskformer_kwargs_from_cfg(cfg)


def test_build_needs_a_card_and_training_is_not_ported(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_maskformer_model()
    # the train forward is ported but for a Swin backbone's drop-path (ROADMAP Queue 1)
    swin = MaskFormer(**TINY, backbone_type="swin", swin=(32, (2, 2, 2, 2), (2, 2, 2, 2), 4, 0.1)).train()
    targets = m2f.MaskTargets(torch.zeros(1, 2, dtype=torch.int64), torch.zeros(1, 2, H // 4, W // 4, dtype=torch.bool),
                              torch.zeros(1, 2, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="drop-path"):
        swin(torch.zeros(1, H, W, 3), torch.tensor([[H, W]]), targets)
    assert m2f.DECODER_LEVELS == ("res5", "res4", "res3")
