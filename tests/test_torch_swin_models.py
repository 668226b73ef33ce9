"""IDOL, SeqFormer and MaskFormer on a Swin backbone against the JAX package's, on the CPU in f32.

Each model at its tests' tiny widths (tests/_tiny_idol.py's IDOL,
tests/test_torch_seqformer.py's and tests/test_torch_mask2former.py's) on the
tiny Swin of tests/test_torch_swin.py (embed 32, depths (1, 1, 2, 1), window
4), one random flax tree bridged to the port. The backbone's outputs are held
element by element (rtol 1e-4 / atol 1e-5); inference whole at 2e-4 of each
output's largest magnitude, as the R50 files hold their whole paths (f32 sums
in other orders through the backbone, the projections' GroupNorm over groups
of few values, and the transformer). Also: the config route gives the Swin
backbone of the published files.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.idol import IDOL as JaxIDOL
from vnext_tpu.models.mask2former import MaskFormer as JaxMaskFormer
from vnext_tpu.models.seqformer import SeqFormer as JaxSeqFormer
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.config import add_idol_config, add_maskformer_config, add_seqformer_config, get_cfg
from vnext_tpu_torch.models.backbones import SWIN_PRESETS
from vnext_tpu_torch.models.idol import IDOL, idol_kwargs_from_cfg
from vnext_tpu_torch.models.mask2former import MaskFormer, maskformer_kwargs_from_cfg
from vnext_tpu_torch.models.seqformer import SeqFormer, seqformer_kwargs_from_cfg

from _torch_helpers import TINY_IDOL, random_params, t

torch.set_num_threads(2)

H, W, NF = 64, 96, 2
SWIN = (32, (1, 1, 2, 1), (2, 2, 4, 4), 4, 0.0)
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def _whole(got, want):
    """2e-4 of each output's largest magnitude (at least 1)."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-4 * max(1.0, np.abs(w).max()), err_msg=k)


def _backbone(port, jmodel, params, frames, stages):
    """The port's backbone against the JAX model's on the same frames."""
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, method=lambda m, x: m.backbone(x)))(
        params, jnp.asarray(frames))
    with torch.no_grad():
        got = port.backbone(t(frames))
    assert set(got) == set(stages)
    for k in stages:
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5)


def _bridged(port, params):
    load_from_jax(port, params)
    assert set(params_from_jax(params)) == set(port.state_dict())
    return port.eval()


def test_idol_swin_matches_jax():
    images = np.random.RandomState(0).randn(2, H, W, 3).astype(np.float32)
    sizes = np.asarray([[64, 85], [56, 96]], np.int32)
    jmodel = JaxIDOL(**TINY_IDOL, max_insts=8, msda_impl="jnp", backbone_type="swin", swin=SWIN)
    args = (jnp.asarray(images), jnp.asarray(sizes))
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), *args, method=JaxIDOL.inference), seed=1)
    port = _bridged(IDOL(**TINY_IDOL, backbone_type="swin", swin=SWIN), params)
    assert port.input_proj_0.conv.weight.shape[1] == 64 and port.input_proj_3.conv.weight.shape[1] == 256
    _backbone(port, jmodel, params, images, ("res3", "res4", "res5"))
    want = jax.jit(lambda p, x, s: jmodel.apply({"params": p}, x, s, method=JaxIDOL.inference))(params, *args)
    with torch.no_grad():
        got = port.inference(t(images), torch.from_numpy(sizes))
    _whole(got, want)


def test_seqformer_swin_matches_jax():
    images = np.random.RandomState(0).randn(1, NF, H, W, 3).astype(np.float32)
    sizes = np.asarray([[56, 85]], np.int32)
    tiny = dict(num_classes=5, hidden_dim=32, num_queries=12, nheads=4, dim_feedforward=64,
                enc_layers=1, dec_layers=2)
    jmodel = JaxSeqFormer(**tiny, msda_impl="jnp", backbone_type="swin", swin=SWIN)
    args = (jnp.asarray(images), jnp.asarray(sizes))
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), *args, method=JaxSeqFormer.inference),
                           seed=1)
    port = _bridged(SeqFormer(**tiny, backbone_type="swin", swin=SWIN), params)
    _backbone(port, jmodel, params, images[0], ("res3", "res4", "res5"))
    want = jax.jit(lambda p, x, s: jmodel.apply({"params": p}, x, s, method=JaxSeqFormer.inference))(params, *args)
    with torch.no_grad():
        got = port.inference(t(images), torch.from_numpy(sizes))
    _whole(got, want)


def test_maskformer_swin_matches_jax():
    images = np.random.RandomState(0).randn(NF, H, W, 3).astype(np.float32)
    sizes = jnp.asarray([[H, W]] * NF, jnp.int32)
    tiny = dict(num_classes=5, hidden_dim=32, num_queries=8, dec_layers=3, enc_layers=1, dim_feedforward=64)
    jmodel = JaxMaskFormer(**tiny, msda_impl="jnp", backbone_type="swin", swin=SWIN)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images), sizes,
                                               method=JaxMaskFormer.inference), seed=1)
    port = _bridged(MaskFormer(**tiny, backbone_type="swin", swin=SWIN), params)
    assert port.pixel_decoder.adapter_res2.weight.shape[1] == 32
    _backbone(port, jmodel, params, images, ("res2", "res3", "res4", "res5"))
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, sizes, method=JaxMaskFormer.inference))(
        params, jnp.asarray(images))
    with torch.no_grad():
        got = port.inference(t(images))
    _whole(got, want)


@pytest.mark.parametrize("rel, add, kwargs_from_cfg", [
    ("idol/ytvis19_swinL.yaml", add_idol_config, idol_kwargs_from_cfg),
    ("idol/ovis_swinL.yaml", add_idol_config, idol_kwargs_from_cfg),
    ("seqformer/swin_ytvis.yaml", add_seqformer_config, seqformer_kwargs_from_cfg),
])
def test_config_route_selects_swin_large(rel, add, kwargs_from_cfg):
    cfg = get_cfg()
    add(cfg)
    cfg.merge_from_file(os.path.join(CONFIGS, rel))
    kw = kwargs_from_cfg(cfg)
    assert kw["backbone_type"] == "swin" and "backbone_depth" not in kw
    assert kw["swin"] == SWIN_PRESETS["L"]


def test_maskformer_config_route_selects_swin():
    """No MinVIS-Swin file is in the repository: the MinVIS-R50 file with the
    backbone switched, as a user would override it."""
    cfg = get_cfg()
    add_maskformer_config(cfg)
    cfg.merge_from_file(os.path.join(CONFIGS, "minvis", "ovis_r50.yaml"))
    cfg.merge_from_list(["MODEL.BACKBONE.NAME", "D2SwinTransformer", "MODEL.SWIN.EMBED_DIM", "192",
                         "MODEL.SWIN.DEPTHS", "[2, 2, 18, 2]", "MODEL.SWIN.NUM_HEADS", "[6, 12, 24, 48]",
                         "MODEL.SWIN.WINDOW_SIZE", "12"])
    kw = maskformer_kwargs_from_cfg(cfg)
    assert kw["backbone_type"] == "swin" and kw["swin"] == SWIN_PRESETS["L"]
    with torch.device("meta"):
        model = MaskFormer(**kw)
    assert model.pixel_decoder.adapter_res2.weight.shape == (256, 192, 1, 1)
    assert model.pixel_decoder.input_proj_0.weight.shape == (256, 1536, 1, 1)
