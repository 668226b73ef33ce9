"""ResNet-18 and ResNet-34 (BasicBlock stages) in the port against the JAX
package's, on the CPU in f32.

The trunk alone (res2..res5 and the channel counts 64 / 128 / 256 / 512, no
4x expansion) and IDOL on ResNet-18 at the quick-schedule config's widths
(``configs/quick_schedules/idol_instant_test.yaml``: hidden 64, 24 queries,
1 + 2 layers), one random flax tree each, bridged to the port, held at 2e-4 of
each output's largest magnitude, as tests/test_torch_resnet101.py holds
ResNet-101 (f32 sums in other orders). The config route builds IDOL-R18 from
the instant config, and its frozen parameters are the JAX recipe's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.backbones.resnet import ResNet as JaxResNet
from vnext_tpu.models.idol import IDOL as JaxIDOL
from vnext_tpu.solver.build import frozen_mask as jax_frozen_mask
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.config import add_idol_config, get_cfg
from vnext_tpu_torch.models.backbones.resnet import BasicBlock, ResNet
from vnext_tpu_torch.models.idol import IDOL, build_idol_model
from vnext_tpu_torch.solver.build import is_frozen

from _torch_helpers import random_params, t

torch.set_num_threads(2)

H, W = 64, 96
SIZES = np.asarray([[64, 85], [56, 96]], np.int32)
INSTANT = dict(num_classes=3, hidden_dim=64, num_queries=24, nheads=4, dim_feedforward=128,
               enc_layers=1, dec_layers=2)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("depth", [18, 34])
def test_basic_trunk_matches_jax(depth):
    images = np.random.RandomState(depth).randn(2, H, W, 3).astype(np.float32)
    feats = ("res2", "res3", "res4", "res5")
    jmodel = JaxResNet(depth=depth, out_features=feats)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(images)), seed=depth)
    port = ResNet(depth, torch.float32, out_features=feats).eval()
    load_from_jax(port, params)
    assert all(isinstance(getattr(port, n), BasicBlock) for s in port.stage_blocks for n in s)
    assert port.output_channels == jmodel.output_channels == {"res2": 64, "res3": 128, "res4": 256, "res5": 512}
    want = jax.jit(lambda p, x: jmodel.apply({"params": p}, x))(params, jnp.asarray(images))
    with torch.no_grad():
        got = port(t(images))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape[1] == port.output_channels[k]
        _close(got[k].permute(0, 2, 3, 1).numpy(), want[k])


def test_idol_r18_matches_jax():
    images = np.random.RandomState(0).randn(2, H, W, 3).astype(np.float32)
    jmodel = JaxIDOL(**INSTANT, max_insts=8, msda_impl="jnp", backbone_depth=18)
    args = (jnp.asarray(images), jnp.asarray(SIZES))
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), *args, method=JaxIDOL.inference), seed=2)
    port = IDOL(**INSTANT, backbone_depth=18).eval()
    load_from_jax(port, params)
    want = jax.jit(lambda p, x, s: jmodel.apply({"params": p}, x, s, method=JaxIDOL.inference))(params, *args)
    with torch.no_grad():
        got = port.inference(t(images), torch.from_numpy(SIZES))
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k])
    # the frozen parameters (FrozenBN anywhere in the backbone, the stem, layer1) are the JAX recipe's
    flat = {".".join(str(p.key) for p in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(jax_frozen_mask(params))[0]}
    names = {n: is_frozen(n) for n, _ in port.named_parameters()}
    for path, frozen in flat.items():
        key = path.replace(".kernel", ".weight").replace(".scale", ".weight")
        assert names[key] == bool(frozen), key


def test_instant_config_builds_idol_r18():
    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs", "quick_schedules",
                                     "idol_instant_test.yaml"))
    model = build_idol_model(cfg, device="cpu")
    assert model.backbone.depth == 18 and model.input_proj_0.conv.weight.shape[1] == 128
    with torch.no_grad():
        out = model.inference(torch.randn(1, 128, 192, 3), torch.tensor([[128, 192]]))
    assert all(torch.isfinite(v.float()).all() for v in out.values())
