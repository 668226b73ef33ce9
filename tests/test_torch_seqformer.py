"""The port's SeqFormer against the JAX package's, on the CPU in f32.

A tiny SeqFormer (as tests/test_model_seqformer.py builds it: 1 + 2 layers,
hidden 32, 12 queries) with one random flax tree, bridged to the port by
``checkpoint/from_jax.py``: the dual-output decode attention (point and box
references), the decoder layer (first and later), the transformer,
``SeqFormer.forward_single`` and ``SeqFormer.inference``. Also: the
constructor's defaults equal the JAX config, ``build_seqformer_model`` raises
without a card, and a Swin backbone's drop-path in training is not ported yet.

On the JAX ResNet's features the input projections are held level by level,
and what follows them runs on the JAX package's projected features: at this
size the stride-64 projection's GroupNorm normalizes groups of 2 values (1
channel x 1 x 2 pixels), some of them nearly equal, so the f32 summation order
of its convolution (XLA's and ``F.conv2d``'s, each within 1e-6 relative of an
f64 evaluation) comes out of the norm amplified ~1000x, above rtol 1e-4, in
both packages alike (``test_input_projection_matches_jax``).
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.backbones.resnet import ResNet as JaxResNet
from vnext_tpu.models.seqformer import SeqFormer as JaxSeqFormer
from vnext_tpu.models.seqformer import SeqFormerDecodeMSDA as JaxDecodeMSDA
from vnext_tpu.models.seqformer import SeqFormerDecoderLayer as JaxDecoderLayer
from vnext_tpu.models.seqformer import SeqFormerTransformer as JaxTransformer
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.models.seqformer import (ClipTargets, SeqFormer, SeqFormerDecodeMSDA, SeqFormerDecoderLayer,
                                              build_seqformer_model, seqformer_kwargs_from_cfg)

from _torch_helpers import random_params, t

torch.set_num_threads(2)

H, W, NF = 64, 96, 3
TINY = dict(num_classes=5, hidden_dim=32, num_queries=12, nheads=4, dim_feedforward=64,
            enc_layers=1, dec_layers=2)
C, M, L, P = 32, 4, 4, 4
LEVELS = ((8, 12), (4, 6), (2, 3), (1, 2))                   # 64x96 at strides 8..64
SIZES = np.asarray([[56, 85]], np.int32)                      # valid (h, w) of the clip
# f32 on both sides, sums in other orders: elementwise rtol 1e-4, atol 1e-5
RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _valid_hw():
    return [np.minimum(-(-SIZES // s), [h, w]).astype(np.int32)
            for s, (h, w) in zip((8, 16, 32, 64), LEVELS)]


def _mask(valid):
    """[1, nf, S] True on padding, as the transformer makes it."""
    rows = []
    for (h, w), v in zip(LEVELS, valid):
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        rows.append(~((ys < v[0, 0]) & (xs < v[0, 1])).reshape(-1))
    return np.broadcast_to(np.concatenate(rows)[None, None], (1, NF, sum(h * w for h, w in LEVELS)))


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    images = rng.randn(1, NF, H, W, 3).astype(np.float32)
    jmodel = JaxSeqFormer(**TINY, msda_impl="jnp")
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images),
                                               jnp.asarray(SIZES), method=JaxSeqFormer.inference), seed=1)
    port = SeqFormer(**TINY, dtype=torch.float32).eval()
    load_from_jax(port, params)
    return images, jmodel, params, port


def test_bridge_covers_every_leaf(models):
    _, _, params, port = models
    state = params_from_jax(params)
    assert set(state) == set(port.state_dict())
    assert len(state) == len(jax.tree.leaves(params))
    for name in ("query_embed", "transformer.level_embed", "transformer.reference_points.weight",
                 "transformer.bbox_embed_1.layers_2.bias", "transformer.decoder_1.cross_attn.output_proj_box.weight",
                 "transformer.decoder_0.self_attn_box.q_proj.weight", "transformer.decoder_0.norm2_box.weight",
                 "transformer.decoder_1.linear2_box.bias", "transformer.decoder_0.time_attention_weights.weight",
                 "controller.layers_2.weight", "mask_head.lay2.weight"):
        assert name in state, name


@pytest.mark.parametrize("form", ["point", "box"])
def test_decode_msda_matches_jax(form):
    rng = np.random.RandomState(3)
    s, q = sum(h * w for h, w in LEVELS), 10
    query = rng.randn(1, NF, q, C).astype(np.float32)
    src = rng.randn(1, NF, s, C).astype(np.float32)
    ref = rng.rand(1, NF, q, L, 2) if form == "point" else np.concatenate(
        [rng.rand(1, NF, q, L, 2), rng.rand(1, NF, q, L, 2) * 0.5 + 0.05], -1)
    ref = ref.astype(np.float32)
    mask = _mask(_valid_hw())
    jmod = JaxDecodeMSDA(d_model=C, n_levels=L, n_heads=M, n_points=P, impl="jnp")
    args = [jnp.asarray(a) for a in (query, ref, src)]
    params = random_params(lambda: jmod.init(jax.random.PRNGKey(0), *args, LEVELS, jnp.asarray(mask)), seed=4)
    want = jmod.apply({"params": params}, *args, LEVELS, jnp.asarray(mask))
    port = SeqFormerDecodeMSDA(C, L, M, P).eval()
    load_from_jax(port, params)
    with torch.no_grad():
        got = port(t(query), t(ref), t(src), LEVELS, torch.from_numpy(mask.copy()))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("first_layer", [True, False], ids=["first", "later"])
def test_decoder_layer_matches_jax(first_layer):
    rng = np.random.RandomState(5)
    s, q = sum(h * w for h, w in LEVELS), 12
    tgt = rng.randn(1, q, C).astype(np.float32)
    tgt_box = rng.randn(*((1, q, C) if first_layer else (1, NF, q, C))).astype(np.float32)
    qpos = rng.randn(1, q, C).astype(np.float32)
    ref = np.concatenate([rng.rand(1, NF, q, L, 2), rng.rand(1, NF, q, L, 2) * 0.4 + 0.05], -1)
    ref = (ref if not first_layer else ref[..., :2]).astype(np.float32)
    src = rng.randn(1, NF, s, C).astype(np.float32)
    mask = _mask(_valid_hw())
    jlayer = JaxDecoderLayer(d_model=C, d_ffn=64, n_levels=L, n_heads=M, n_points=P, msda_impl="jnp")
    args = [jnp.asarray(a) for a in (tgt, tgt_box, qpos, ref, src)]
    params = random_params(lambda: jlayer.init(jax.random.PRNGKey(0), *args, LEVELS, jnp.asarray(mask),
                                               False, first_layer), seed=6)
    want = jlayer.apply({"params": params}, *args, LEVELS, jnp.asarray(mask), False, first_layer)
    port = SeqFormerDecoderLayer(C, 64, L, M, P).eval()
    load_from_jax(port, params)
    with torch.no_grad():
        got = port(t(tgt), t(tgt_box), t(qpos), t(ref), t(src), LEVELS,
                   torch.from_numpy(mask.copy()), first_layer)
    for g, w in zip(got, want):
        _close(g, w)


def test_transformer_matches_jax(models):
    _, _, params, port = models
    rng = np.random.RandomState(2)
    srcs = [rng.randn(1, NF, h, w, C).astype(np.float32) for h, w in LEVELS]
    poses = [rng.randn(1, NF, h, w, C).astype(np.float32) for h, w in LEVELS]
    valid = _valid_hw()
    jtr = JaxTransformer(d_model=C, n_heads=M, num_encoder_layers=1, num_decoder_layers=2, d_ffn=64,
                         msda_impl="jnp")
    want = jax.jit(lambda p, q, s, v, e: jtr.apply({"params": p}, s, v, e, q))(
        params["transformer"], params["query_embed"], [jnp.asarray(x) for x in srcs],
        [jnp.asarray(x) for x in valid], [jnp.asarray(x) for x in poses])
    with torch.no_grad():
        got = port.transformer([t(x).flatten(0, 1) for x in srcs],
                               [torch.from_numpy(v).repeat_interleave(NF, 0) for v in valid],
                               [t(x).flatten(0, 1) for x in poses], port.query_embed, NF)
    names = ("hs", "hs_box", "memory", "init_reference", "inter_refs", "out_coords")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        _close(g, w)


def _jax_backbone(params, images):
    """res3..res5 of the JAX ResNet-50 on the clip's frames, NCHW torch tensors."""
    jnet = JaxResNet(depth=50, out_features=("res3", "res4", "res5"))
    feats = jax.jit(lambda p, x: jnet.apply({"params": p}, x))(
        params["backbone"], jnp.asarray(images.reshape(-1, H, W, 3)))
    return {k: torch.from_numpy(np.array(v)).permute(0, 3, 1, 2) for k, v in feats.items()}


def _port_inference(port, images, backbone_feats=None, method="inference"):
    backbone = port.backbone.forward
    if backbone_feats is not None:
        port.backbone.forward = lambda x: backbone_feats
    try:
        with torch.no_grad():
            return getattr(port, method)(t(images), torch.from_numpy(SIZES))
    finally:
        port.backbone.forward = backbone


def _jax_features(params, jmodel, images):
    """The JAX model's projected features (srcs, valid (h, w), positions) in the
    port's layout: L x [nf, H_l, W_l, C], L x [nf, 2], L x [nf, H_l, W_l, C]."""
    srcs, valid, poses = jax.jit(lambda p, x, s: jmodel.apply({"params": p}, x, s,
                                                              method=JaxSeqFormer.extract_features))(
        params, jnp.asarray(images), jnp.asarray(SIZES))
    fold = lambda xs: [torch.from_numpy(np.array(x)).flatten(0, 1) for x in xs]
    return fold(srcs), [torch.from_numpy(np.array(v)).repeat_interleave(NF, 0) for v in valid], fold(poses)


def _port_on_jax_features(port, features, method):
    """The port from its transformer on: ``extract_features`` returns the JAX
    model's projected features."""
    port.extract_features = lambda images, sizes: features
    try:
        with torch.no_grad():
            return getattr(port, method)(torch.zeros(1, NF, H, W, 3), torch.from_numpy(SIZES))
    finally:
        del port.extract_features


def _conv_gn_f64(x, p, stride, pad, groups=32, eps=1e-6):
    """flax ``ConvGN`` (conv with bias, GroupNorm with flax's statistics) in f64:
    x [N, Cin, H, W]; p the flax tree of the projection."""
    k = torch.from_numpy(np.asarray(p["conv"]["kernel"], np.float64)).permute(3, 2, 0, 1)
    y = torch.nn.functional.conv2d(x.double(), k, torch.from_numpy(np.asarray(p["conv"]["bias"], np.float64)),
                                   stride=stride, padding=pad)
    g = y.reshape(y.shape[0], groups, -1)
    mu = g.mean(-1, keepdim=True)
    var = (g * g).mean(-1, keepdim=True) - mu * mu
    out = ((g - mu) / torch.sqrt(var + eps)).reshape(y.shape)
    scale = torch.from_numpy(np.asarray(p["norm"]["scale"], np.float64))[:, None, None]
    bias = torch.from_numpy(np.asarray(p["norm"]["bias"], np.float64))[:, None, None]
    return (out * scale + bias).permute(0, 2, 3, 1)                    # [N, H, W, C]


@pytest.fixture(scope="module")
def jax_backbone(models):
    images, _, params, _ = models
    return _jax_backbone(params, images)


@pytest.fixture(scope="module")
def jax_features(models):
    """The JAX model's projected features, one ``jit`` shared by every test here."""
    images, jmodel, params, _ = models
    return _jax_features(params, jmodel, images)


@pytest.fixture(scope="module")
def port_features(models, jax_backbone):
    """The port's projected features on the JAX ResNet's."""
    images, _, _, port = models
    return _port_inference(port, images, jax_backbone, method="extract_features")


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_input_projection_matches_jax(models, jax_backbone, jax_features, port_features, level):
    """Each level's input projection (ConvGN) on the JAX ResNet's features.
    Levels 0-2 element by element (rtol 1e-4, atol 1e-5). Level 3 is the
    stride-64 3x3 projection of res5 onto a 1 x 2 map: with hidden 32 and 32
    groups each GroupNorm group holds 2 values, and where they nearly agree
    (here |x1 - x2| down to 0.0095 at |x| up to 3.6) the variance E[x^2] -
    E[x]^2 cancels, so the f32 summation order of the convolution, one library
    op (XLA's and ``F.conv2d``'s outputs each lie within 5e-6 of its f64
    evaluation; GroupNorm of identical inputs agrees within 6e-6), leaves the
    norm amplified: 2.5e-3 between the packages, 3.0e-3 between the JAX
    package and f64. So level 3 is held against the f64 evaluation of the
    stage, within rtol 1e-4 / atol 1e-5 plus twice the JAX package's own f32
    error on that stage alone: the port must be as exact as the reference."""
    params, feats, got, want = models[2], jax_backbone, port_features, jax_features
    for g, w in zip(got, want):
        assert len(g) == len(w) == 4
    _close(got[1][level], want[1][level], rtol=0, atol=0)
    _close(got[2][level], want[2][level])
    if level < 3:
        _close(got[0][level], want[0][level])
        return
    exact = _conv_gn_f64(feats["res5"], params["input_proj_3"], stride=2, pad=1)
    noise = float((want[0][level].double() - exact).abs().max())
    _close(got[0][level].double(), exact.numpy(), atol=ATOL + 2 * noise)


@pytest.fixture(scope="module")
def jax_inference(models):
    images, jmodel, params, _ = models
    return jax.jit(lambda p, x, s: jmodel.apply({"params": p}, x, s, method=JaxSeqFormer.inference))(
        params, jnp.asarray(images), jnp.asarray(SIZES))


def test_inference_matches_jax(models, jax_inference, jax_features):
    """Everything after the input projections (the backbone's own parity is
    tests/test_torch_idol.py's, the projections' test_input_projection_matches_jax):
    the port runs on the JAX model's projected features. Logits and boxes
    element by element (rtol 1e-4, atol 1e-5); the mask logits reach +-50 and
    cross zero, where f32 sums of that size differ by more than 1e-5 in another
    order, so they are held to 1e-4 of their largest magnitude."""
    port = models[3]
    want = jax_inference
    got = _port_on_jax_features(port, jax_features, "inference")
    assert set(got) == set(want) == {"pred_logits", "pred_boxes", "pred_masks"}
    assert got["pred_masks"].shape == (TINY["num_queries"], NF, H // 4, W // 4)
    assert got["pred_boxes"].shape == (NF, TINY["num_queries"], 4)
    _close(got["pred_logits"], want["pred_logits"])
    _close(got["pred_boxes"], want["pred_boxes"])
    masks = np.asarray(want["pred_masks"])
    _close(got["pred_masks"], masks, rtol=0, atol=1e-4 * np.abs(masks).max())


def test_inference_with_its_own_backbone_matches_jax(models, jax_inference):
    """The whole path, ResNet-50 included, at the IDOL inference test's
    tolerance: 2e-4 of each output's largest magnitude (f32 sums in other orders
    through 53 convolutions)."""
    images, _, _, port = models
    got = _port_inference(port, images)
    for k, w in jax_inference.items():
        w = np.asarray(w)
        _close(got[k], w, rtol=0, atol=2e-4 * max(1.0, np.abs(w).max()))


def test_forward_single_matches_jax(models, jax_features):
    """Every decoder layer's class logits, boxes and mask reference points, on
    the JAX model's projected features (as test_inference_matches_jax), element
    by element (rtol 1e-4, atol 1e-5)."""
    images, jmodel, params, port = models
    want = jax.jit(lambda p, x, s: jmodel.apply({"params": p}, x, s, False,
                                                method=JaxSeqFormer.forward_single))(
        params, jnp.asarray(images), jnp.asarray(SIZES))
    got = _port_on_jax_features(port, jax_features, "forward_single")
    assert got["logits"].shape == (TINY["dec_layers"], 1, TINY["num_queries"], TINY["num_classes"])
    for name in ("logits", "boxes"):
        _close(got[name], want[name])
    assert len(got["pre_refs"]) == len(want["pre_refs"]) == TINY["dec_layers"]
    for g, w in zip(got["pre_refs"], want["pre_refs"]):
        _close(g, w)


def test_training_is_not_ported(models):
    """The train forward is ported (tests/test_torch_seqformer_train.py) but for
    a Swin backbone's drop-path (ROADMAP Queue 1)."""
    swin = SeqFormer(**TINY, backbone_type="swin", swin=(32, (2, 2, 2, 2), (2, 2, 2, 2), 4, 0.1)).train()
    k = 2
    targets = ClipTargets(torch.zeros(1, k, dtype=torch.int64), torch.zeros(1, k, NF, 4),
                          torch.zeros(1, k, NF, H // 4, W // 4, dtype=torch.bool), torch.zeros(1, k, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="drop-path"):
        swin(torch.zeros(1, NF, H, W, 3), torch.from_numpy(SIZES), targets)


def _ytvis19_r50_cfg():
    from vnext_tpu.config import add_seqformer_config, get_cfg

    cfg = get_cfg()
    add_seqformer_config(cfg)
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs", "seqformer", "ytvis19_r50.yaml"))
    return cfg


def test_config_route_equals_defaults():
    """The port's defaults are SeqFormer-R50 as configs/seqformer/ytvis19_r50.yaml
    sets it, so a caller without the JAX package's config reader gets the same model."""
    kw = seqformer_kwargs_from_cfg(_ytvis19_r50_cfg())
    assert kw.pop("dtype") == torch.bfloat16
    defaults = {k: p.default for k, p in inspect.signature(SeqFormer.__init__).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert kw == {k: defaults[k] for k in kw}
    # every argument but the dtype, and the Swin preset, which an R50 file does not select
    assert set(defaults) - set(kw) == {"dtype", "swin"}


def test_config_msda_impl_and_swin():
    """The selector's key passes through; a Swin backbone name selects Swin from
    MODEL.SWIN (the file's T defaults here, as the JAX builder reads them), and
    STRIDE_IN_1X1, which the JAX builder ignores, raises."""
    cfg = _ytvis19_r50_cfg()
    cfg.TPU.MSDA_IMPL = "pallas_v8"
    assert seqformer_kwargs_from_cfg(cfg)["msda_impl"] == "pallas_v8"
    cfg.MODEL.BACKBONE.NAME = "D2SwinTransformer"
    kw = seqformer_kwargs_from_cfg(cfg)
    assert kw["backbone_type"] == "swin" and "backbone_depth" not in kw
    assert kw["swin"] == (96, (2, 2, 6, 2), (3, 6, 12, 24), 7, 0.3)
    cfg.MODEL.RESNETS.STRIDE_IN_1X1 = True
    with pytest.raises(NotImplementedError, match="STRIDE_IN_1X1.*ignores"):
        seqformer_kwargs_from_cfg(cfg)


def test_build_seqformer_model_targets_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_seqformer_model()
