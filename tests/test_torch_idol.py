"""The port's IDOL-R50 inference slice against the JAX package, on the CPU in f32.

A tiny IDOL (tests/_tiny_idol.py: hidden 32, 4 heads, 1 encoder and 2 decoder
layers, 20 queries, full ResNet-50) gets one random flax parameter tree, which
the weight bridge loads into the port. Then the backbone's res3..res5, the
deformable transformer's outputs and the four outputs of ``IDOL.inference``
must agree, with the JAX package on its jnp MSDA path. Also: the bridge covers
every leaf in both directions, and the port's config readers give the
constructor defaults for ``configs/idol/ytvis19_r50.yaml``.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.backbones.resnet import ResNet as JaxResNet
from vnext_tpu.models.deformable_transformer import DeformableTransformer as JaxTransformer
from vnext_tpu.models.idol import IDOL as JaxIDOL
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.engine.vis_inference import IDOLVideoInference, runner_kwargs_from_cfg
from vnext_tpu_torch.models.idol import IDOL, build_idol_model, idol_kwargs_from_cfg

from _tiny_idol import H, W, make_model
from _torch_helpers import TINY_IDOL, random_params, t

torch.set_num_threads(2)

SIZES = np.asarray([[64, 85], [56, 96]], np.int32)   # valid (h, w): padded width, padded height
# f32 on both sides; sums in other orders through ResNet-50 and the trunk.
# Tolerances are relative to each output's largest magnitude.
TOL = 2e-4


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs error {err} > {tol} x {scale}"


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    images = rng.randn(2, H, W, 3).astype(np.float32)
    jmodel = make_model()
    args = (jnp.asarray(images), jnp.asarray(SIZES))
    params = random_params(
        lambda: jmodel.init(jax.random.PRNGKey(0), *args, method=JaxIDOL.inference), seed=1)
    port = IDOL(**TINY_IDOL, dtype=torch.float32).eval()
    load_from_jax(port, params)
    return images, jmodel, params, port


def test_bridge_covers_every_leaf(models):
    _, _, params, port = models
    state = params_from_jax(params)
    own = port.state_dict()
    assert set(state) == set(own)
    assert len(state) == len(jax.tree.leaves(params))
    for k, v in own.items():
        assert tuple(v.shape) == tuple(state[k].shape), k
    # a leaf left over in either direction raises
    pruned = jax.tree.map(lambda x: x, params)
    del pruned["transformer"]["level_embed"]
    with pytest.raises(KeyError, match="level_embed"):
        load_from_jax(port, pruned)
    extra = {**params, "stray": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="stray"):
        load_from_jax(port, extra)


def test_resnet_res3_to_res5(models):
    images, _, params, port = models
    jnet = JaxResNet(depth=50, out_features=("res3", "res4", "res5"))
    want = jax.jit(lambda p, x: jnet.apply({"params": p}, x))(params["backbone"], jnp.asarray(images))
    with torch.no_grad():
        got = port.backbone(t(images))
    for k in ("res3", "res4", "res5"):
        _close(got[k].permute(0, 2, 3, 1).numpy(), want[k])


def test_transformer_outputs(models):
    _, _, params, port = models
    rng = np.random.RandomState(2)
    level_hw = ((8, 12), (4, 6), (2, 3), (1, 2))                       # 64x96 at strides 8..64
    srcs = [rng.randn(2, h, w, 32).astype(np.float32) for h, w in level_hw]
    poses = [rng.randn(2, h, w, 32).astype(np.float32) for h, w in level_hw]
    valid = [np.minimum(-(-SIZES // s), [h, w]).astype(np.int32)
             for s, (h, w) in zip((8, 16, 32, 64), level_hw)]
    jtr = JaxTransformer(d_model=32, n_heads=4, num_encoder_layers=1, num_decoder_layers=2,
                         d_ffn=64, msda_impl="jnp")
    want = jax.jit(lambda p, q, s, v, e: jtr.apply({"params": p}, s, v, e, q))(
        params["transformer"], params["query_embed"], [jnp.asarray(x) for x in srcs],
        [jnp.asarray(x) for x in valid], [jnp.asarray(x) for x in poses])
    with torch.no_grad():
        got = port.transformer([t(x) for x in srcs], [torch.from_numpy(v) for v in valid],
                               [t(x) for x in poses], port.query_embed)
    for name, g, w in zip(("hs", "memory", "init_ref", "inter_refs", "out_coords"), got, want):
        _close(g.numpy(), w, tol=1e-4)


def test_inference_outputs(models):
    images, jmodel, params, port = models
    want = jax.jit(lambda p, x, s: jmodel.apply({"params": p}, x, s, method=JaxIDOL.inference))(
        params, jnp.asarray(images), jnp.asarray(SIZES))
    with torch.no_grad():
        got = port.inference(t(images), torch.from_numpy(SIZES))
    assert set(got) == set(want) == {"pred_logits", "pred_boxes", "pred_inst_embed", "pred_masks"}
    assert got["pred_masks"].shape == (2, TINY_IDOL["num_queries"], H // 4, W // 4)
    for k in want:
        _close(got[k].numpy(), want[k])


def _ytvis19_r50_cfg():
    from vnext_tpu.config import add_idol_config, get_cfg

    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs", "idol", "ytvis19_r50.yaml"))
    return cfg


def test_config_route_equals_defaults():
    """The port's defaults are IDOL-R50 as configs/idol/ytvis19_r50.yaml sets it,
    so a caller without the JAX package's config reader gets the same model."""
    cfg = _ytvis19_r50_cfg()
    kw = idol_kwargs_from_cfg(cfg)
    assert kw.pop("dtype") == torch.bfloat16
    defaults = {k: p.default for k, p in inspect.signature(IDOL.__init__).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert kw == {k: defaults[k] for k in kw}
    assert build_idol_model(cfg).dtype == build_idol_model().dtype == torch.bfloat16

    run_kw = runner_kwargs_from_cfg(cfg)
    run_defaults = {k: p.default for k, p in inspect.signature(IDOLVideoInference.__init__).parameters.items()
                    if p.default is not inspect.Parameter.empty}
    assert run_kw == {k: run_defaults[k] for k in run_kw}


def test_fused_tracker_is_not_ported():
    cfg = _ytvis19_r50_cfg()
    cfg.TPU.FUSED_TRACKER = True
    tiny = IDOL(**TINY_IDOL)
    with pytest.raises(NotImplementedError, match="on-device tracker"):
        IDOLVideoInference.from_config(cfg, tiny)
