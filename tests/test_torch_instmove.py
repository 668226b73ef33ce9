"""The port's InstMove motion predictor against the JAX package's, on the CPU in f32.

Each piece gets a random flax tree, bridged by ``checkpoint/from_jax.py`` (3-D
kernels DHWIO -> OIDHW; ``ConvTranspose`` kernels keep the 4-d layout and are
arranged at use): ``ConvTranspose`` alone against ``flax.linen.ConvTranspose``
at strides 1 and 2 and odd and even sizes, the SAME stride-2 convolution,
``MotionEncoder3D`` (odd sides, where its max-pools floor), ``MotionMemory``,
``Decoder``, the tiny predictor of tests/test_toolkit.py (one and two predicted
steps) and ``motion_match_cost``. At mask sides that are not multiples of 16
the JAX package fails at a concat and the port raises a ``ValueError`` naming
both shapes. f32 on both sides, sums in other orders: rtol 1e-4, atol 1e-5
unless a test says otherwise.
"""

import inspect

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models import instmove as jim
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.models import instmove as im

from _torch_helpers import random_params, t

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(memory_size=8, num_lstm_layers=2, lstm_channels=16)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _bridged(jmod, port, *args, seed=0):
    """(random flax params for ``jmod`` at ``args``, JAX output); loads them into ``port``."""
    params = random_params(lambda: jmod.init(jax.random.PRNGKey(0), *args), seed=seed)
    load_from_jax(port, params)
    return params, jmod.apply({"params": params}, *args)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(5, 7), (6, 8)], ids=["odd", "even"])
def test_conv_transpose_matches_flax(stride, hw):
    """flax's default ``transpose_kernel=False`` and "SAME": output side = input
    x stride, the kernel neither flipped nor swapped."""
    x = np.random.RandomState(stride).randn(2, *hw, 6).astype(np.float32)
    port = im.ConvTranspose(6, 4, 3, stride)
    _, want = _bridged(fnn.ConvTranspose(4, (3, 3), strides=(stride, stride), padding="SAME"), port,
                       jnp.asarray(x), seed=stride)
    assert want.shape == (2, hw[0] * stride, hw[1] * stride, 4)
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), want)


@pytest.mark.parametrize("hw", [(9, 12), (8, 11)], ids=["odd-even", "even-odd"])
def test_conv_same_at_stride_2_matches_flax(hw):
    """SAME at stride 2 pads (0, 1) along an even side and (1, 1) along an odd one."""
    x = np.random.RandomState(3).randn(2, *hw, 3).astype(np.float32)
    port = im.ConvSame(3, 5, 3, 2)
    _, want = _bridged(fnn.Conv(5, (3, 3), strides=(2, 2), padding="SAME"), port, jnp.asarray(x))
    with torch.no_grad():
        _close(_nhwc(port(_nchw(x))), want)


def test_motion_encoder_3d_matches_jax():
    """Three difference frames at 36 x 50: the max-pools floor 50 -> 25 -> 12 -> 6 -> 3."""
    x = np.random.RandomState(4).randn(2, 3, 36, 50, 1).astype(np.float32)
    port = im.MotionEncoder3D()
    params, want = _bridged(jim.MotionEncoder3D(), port, jnp.asarray(x))
    assert params["conv1"]["kernel"].shape == (3, 3, 3, 1, 64)
    assert port.conv1.weight.shape == (64, 1, 3, 3, 3)
    assert want.shape == (2, 2, 3, 512)
    with torch.no_grad():
        _close(_nhwc(port(t(x)[..., 0][:, None])), want)


def test_motion_memory_matches_jax():
    """Cosine addressing with an f32 softmax over 8 memory slots, then two
    stride-2 transposed convolutions to a quarter of the mask sides."""
    x = np.random.RandomState(5).rand(2, 4, 32, 48, 1).astype(np.float32)
    port = im.MotionMemory(8, 16)
    params, want = _bridged(jim.MotionMemory(8, embed_channels=16), port, jnp.asarray(x))
    assert "memory_w" in params and set(params) == {"memory_w", "motion_matching_encoder", "embed1", "embed2"}
    assert want.shape == (2, 8, 12, 16)
    with torch.no_grad():
        _close(_nhwc(port(t(x)[..., 0])), want)


def test_decoder_matches_jax():
    """The image-conditioned decoder: res3 and res2 skips resized to the
    running feature, ResBlocks, four transposed convolutions, one logit channel."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    feats = {"res3": rng.randn(2, 4, 4, 512).astype(np.float32),
             "res2": rng.randn(2, 8, 8, 256).astype(np.float32)}
    port = im.Decoder(32)
    _, want = _bridged(jim.Decoder(channels=32), port, jnp.asarray(x), {k: jnp.asarray(v) for k, v in feats.items()})
    assert want.shape == (2, 32, 32, 1)
    with torch.no_grad():
        got = port(_nchw(x), {k: _nchw(v) for k, v in feats.items()})
    _close(_nhwc(got), want)


@pytest.fixture(scope="module")
def predictor():
    rng = np.random.RandomState(0)
    masks = rng.rand(2, 4, 64, 64, 1).astype(np.float32)
    image = rng.randn(2, 64, 64, 3).astype(np.float32)
    jmodel = jim.InstMovePredictor(**TINY)
    params = random_params(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(masks), jnp.asarray(image)),
                           seed=7)
    port = im.InstMovePredictor(**TINY).eval()
    load_from_jax(port, params)
    return masks, image, jmodel, params, port


def test_bridge_covers_every_leaf(predictor):
    *_, params, port = predictor
    state = params_from_jax(params)
    assert set(state) == set(port.state_dict())
    assert len(state) == len(jax.tree.leaves(params))
    for name in ("enc1.weight", "convlstm_1.conv_h.weight", "memory.memory_w", "memory.embed2.weight",
                 "memory.motion_matching_encoder.conv6.weight", "encoder_img.layer4_2.conv3.weight",
                 "attn_fc2.bias", "decoder.up_m.weight", "decoder.out.bias", "decoder.res1.conv2.weight"):
        assert name in state, name


@pytest.mark.parametrize("out_len", [1, 2])
def test_predictor_matches_jax(predictor, out_len):
    """The tiny predictor (memory 8, 2 ConvLSTM layers of 16 channels, full
    ResNet-50) on 4 past masks at 64 x 64; with ``out_len`` 2 its first
    prediction is fed back through a sigmoid."""
    masks, image, jmodel, params, port = predictor
    want = jax.jit(lambda p, m, x: jmodel.apply({"params": p}, m, x, out_len=out_len))(
        params, jnp.asarray(masks), jnp.asarray(image))
    with torch.no_grad():
        got = port(t(masks), t(image), out_len=out_len)
    assert got.shape == (2, out_len, 64, 64, 1)
    _close(got, want)


@pytest.mark.parametrize("hw", [(90, 160), (120, 216)], ids=["ovis-360x640", "480x864"])
def test_mask_sides_not_multiple_of_16_fail_in_both(hw):
    """JAX fails at the concat of the LSTM state and the memory feature; the port
    raises a ValueError with both shapes before any work."""
    h, w = hw
    masks = jnp.zeros((1, 4, h, w, 1))
    image = jnp.zeros((1, 4 * h, 4 * w, 3))
    with pytest.raises(TypeError):
        jax.eval_shape(lambda: jim.InstMovePredictor(**TINY).init(jax.random.PRNGKey(0), masks, image))
    mem, lstm = (4 * (h // 16), 4 * (w // 16)), (-(-h // 4), -(-w // 4))
    port = im.InstMovePredictor(**TINY)
    with pytest.raises(ValueError, match=rf"{mem[0]}x{mem[1]}.*{lstm[0]}x{lstm[1]}.*multiples of 16"):
        port(torch.zeros(1, 4, h, w, 1), torch.zeros(1, 4 * h, 4 * w, 3))


def test_motion_match_cost_matches_jax():
    rng = np.random.RandomState(8)
    pred, cand = rng.randn(3, 16, 16).astype(np.float32), rng.randn(4, 16, 16).astype(np.float32)
    want = jim.motion_match_cost(jnp.asarray(pred), jnp.asarray(cand))
    got = im.motion_match_cost(t(pred), t(cand))
    _close(got, want, rtol=0, atol=1e-6)


def test_config_route_equals_defaults_and_build_needs_a_card(monkeypatch):
    from vnext_tpu.config import get_cfg
    from vnext_tpu.config.extensions import add_maskformer_config

    cfg = get_cfg()
    add_maskformer_config(cfg)
    kw = im.instmove_kwargs_from_cfg(cfg)
    defaults = {k: p.default for k, p in inspect.signature(im.InstMovePredictor.__init__).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert kw == {k: defaults[k] for k in kw} and defaults["dtype"] == torch.float32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        im.build_instmove_model()
