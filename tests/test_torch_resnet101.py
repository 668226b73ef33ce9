"""IDOL on ResNet-101, in the torchvision and the MSRA layout, against the JAX package's, on the CPU in f32.

tests/_tiny_idol.py's IDOL (hidden 32, 1 + 2 layers, 20 queries) on the full
ResNet-101 trunk (3, 4, 23, 3 Bottlenecks) with ``stride_in_1x1`` off (the
stride on the 3x3) and on (on the first 1x1), one random flax tree each,
bridged to the port. res3..res5 and the four inference outputs at 2e-4 of each
output's largest magnitude, as tests/test_torch_idol.py holds ResNet-50's and
the whole path (f32 sums in other orders through 104 convolutions). Also: the
config route passes ``STRIDE_IN_1X1`` and the depth, and depths no ResNet has
raise (18 and 34 are held against JAX in tests/test_torch_resnet_basic.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.idol import IDOL as JaxIDOL
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.config import add_idol_config, get_cfg
from vnext_tpu_torch.models.backbones.resnet import ResNet
from vnext_tpu_torch.models.idol import IDOL, idol_kwargs_from_cfg

from _torch_helpers import TINY_IDOL, random_params, t

torch.set_num_threads(2)

H, W = 64, 96
SIZES = np.asarray([[64, 85], [56, 96]], np.int32)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("stride_in_1x1", [False, True], ids=["torchvision", "msra"])
def test_idol_r101_matches_jax(stride_in_1x1):
    images = np.random.RandomState(0).randn(2, H, W, 3).astype(np.float32)
    jmodel = JaxIDOL(**TINY_IDOL, max_insts=8, msda_impl="jnp", backbone_depth=101, stride_in_1x1=stride_in_1x1)
    args = (jnp.asarray(images), jnp.asarray(SIZES))
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), *args, method=JaxIDOL.inference), seed=1)
    port = IDOL(**TINY_IDOL, backbone_depth=101, stride_in_1x1=stride_in_1x1).eval()
    load_from_jax(port, params)
    block = port.backbone.layer2_0
    assert (block.conv1.stride, block.conv2.stride) == ((2, 1) if stride_in_1x1 else (1, 2))
    assert len(port.backbone.stage_blocks[2]) == 23

    # one trace: the backbone's outputs captured inside the inference
    want, state = jax.jit(lambda p, x, s: jmodel.apply(
        {"params": p}, x, s, method=JaxIDOL.inference, mutable=["intermediates"],
        capture_intermediates=lambda mdl, name: mdl.name == "backbone" and name == "__call__"))(params, *args)
    feats = state["intermediates"]["backbone"]["__call__"][0]
    with torch.no_grad():
        got_feats = port.backbone(t(images))
        got = port.inference(t(images), torch.from_numpy(SIZES))
    for k in ("res3", "res4", "res5"):
        _close(got_feats[k].permute(0, 2, 3, 1).numpy(), feats[k])
    assert set(got) == set(want)
    for k in want:
        _close(got[k].numpy(), want[k])


@pytest.mark.parametrize("stride_in_1x1", [False, True])
def test_config_route_r101(stride_in_1x1):
    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs", "idol", "ytvis19_r101.yaml"))
    cfg.MODEL.RESNETS.STRIDE_IN_1X1 = stride_in_1x1
    kw = idol_kwargs_from_cfg(cfg)
    assert (kw["backbone_type"], kw["backbone_depth"], kw["stride_in_1x1"]) == ("resnet", 101, stride_in_1x1)


@pytest.mark.parametrize("depth, error", [(26, ValueError), (77, ValueError)])
def test_depths_the_port_lacks_raise(depth, error):
    with pytest.raises(error, match=str(depth)):
        ResNet(depth)
    with torch.device("meta"):
        assert sum(len(s) for s in ResNet(152).stage_blocks) == 50
