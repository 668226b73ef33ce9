"""The port's building blocks against the JAX package's, on the CPU in f32.

Interpolation matrices, the sine position embedding, encoder reference points,
``inverse_sigmoid``, FrozenBatchNorm, ConvGN (GroupNorm eps 1e-6), the decoder's
MultiHeadAttention and the CondInst mask head, each with the same numpy inputs
and bridged random weights. Layouts differ only where the port is NCHW inside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models import condinst as jax_condinst
from vnext_tpu.models import layers as jax_layers
from vnext_tpu.models.deformable_transformer import encoder_reference_points as jax_enc_ref
from vnext_tpu.models.position_encoding import sine_position_embedding as jax_sine
from vnext_tpu.ops import interpolate as jax_interp
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.models import condinst, layers
from vnext_tpu_torch.models.deformable_transformer import encoder_reference_points
from vnext_tpu_torch.models.position_encoding import sine_position_embedding
from vnext_tpu_torch.ops import interpolate

from _torch_helpers import random_params, t

torch.set_num_threads(2)

TOL = 1e-5   # one f32 op chain; sums in other orders


def _nchw(x):
    return t(np.moveaxis(x, -1, 1))


def _nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("fn,args", [
    ("resize_bilinear", (13, 21)), ("resize_bilinear", (40, 7)),
    ("resize_nearest", (13, 21)), ("resize_nearest", (40, 7)),
    ("aligned_bilinear", (2,)), ("aligned_bilinear", (4,)),
])
def test_interpolate_matches_jax(fn, args):
    x = np.random.RandomState(0).randn(2, 3, 10, 14).astype(np.float32)
    got = getattr(interpolate, fn)(t(x), *args).numpy()
    want = np.asarray(getattr(jax_interp, fn)(jnp.asarray(x), *args))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_compute_locations_matches_jax():
    got = interpolate.compute_locations(5, 7, 8).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_interp.compute_locations(5, 7, 8)))


@pytest.mark.parametrize("feats", [16, 128])
def test_sine_position_embedding_matches_jax(feats):
    vhw = np.asarray([[8, 11], [5, 12]], np.int32)
    got = sine_position_embedding(torch.from_numpy(vhw), 8, 12, feats).numpy()
    want = np.asarray(jax_sine(jnp.asarray(vhw), 8, 12, feats))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_encoder_reference_points_match_jax():
    shapes = ((8, 12), (4, 6), (2, 3))
    vr = np.asarray([[[1.0, 1.0]] * 3, [[0.75, 0.9]] * 3], np.float32)
    got = encoder_reference_points(shapes, t(vr)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_enc_ref(shapes, jnp.asarray(vr))), atol=1e-6, rtol=0)


def test_inverse_sigmoid_matches_jax():
    x = np.asarray([-0.5, 0.0, 1e-7, 0.3, 0.999999, 1.0, 1.5], np.float32)
    np.testing.assert_allclose(layers.inverse_sigmoid(t(x)).numpy(),
                               np.asarray(jax_layers.inverse_sigmoid(jnp.asarray(x))), atol=TOL, rtol=0)


def _bridged(jmod, port, *args, seed=0, **kw):
    params = random_params(lambda: jmod.init(jax.random.PRNGKey(0), *args, **kw), seed=seed)
    load_from_jax(port, params)
    return np.asarray(jmod.apply({"params": params}, *args, **kw))


def test_frozen_batch_norm_matches_jax():
    x = np.random.RandomState(1).randn(2, 5, 6, 16).astype(np.float32)
    port = layers.FrozenBatchNorm(16)
    want = _bridged(jax_layers.FrozenBatchNorm(16), port, jnp.asarray(x), seed=2)
    np.testing.assert_allclose(_nhwc(port(_nchw(x))), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("kernel_size,stride", [(1, 1), (3, 2)])
def test_conv_gn_matches_jax(kernel_size, stride):
    x = np.random.RandomState(3).randn(2, 9, 12, 48).astype(np.float32)
    port = layers.ConvGN(48, 64, kernel_size, stride)
    want = _bridged(jax_layers.ConvGN(64, kernel_size=kernel_size, stride=stride), port,
                    jnp.asarray(x), seed=4)
    np.testing.assert_allclose(_nhwc(port(_nchw(x))), want, atol=1e-4, rtol=0)


def test_multi_head_attention_matches_jax():
    rng = np.random.RandomState(5)
    q, v = rng.randn(2, 20, 32).astype(np.float32), rng.randn(2, 20, 32).astype(np.float32)
    port = layers.MultiHeadAttention(32, 4)
    want = _bridged(jax_layers.MultiHeadAttention(4), port, jnp.asarray(q), jnp.asarray(q),
                    jnp.asarray(v), seed=6)
    np.testing.assert_allclose(port(t(q), t(q), t(v)).detach().numpy(), want, atol=TOL, rtol=0)


def test_mask_head_and_dynamic_convs_match_jax():
    rng = np.random.RandomState(7)
    feats = [rng.randn(2, h, w, 32).astype(np.float32) for h, w in ((8, 12), (4, 6), (2, 3))]
    head = condinst.MaskHeadSmallConv(32)
    want_feats = _bridged(jax_condinst.MaskHeadSmallConv(32), head,
                          [jnp.asarray(f) for f in feats], seed=8)
    got_feats = head([_nchw(f) for f in feats])
    np.testing.assert_allclose(_nhwc(got_feats), want_feats, atol=1e-4, rtol=0)

    n = 6
    refs = (rng.rand(2, n, 2) * [96, 64]).astype(np.float32)
    params = (rng.randn(2, n, condinst.num_dynamic_params(1)) * 0.3).astype(np.float32)
    want = np.asarray(jax_condinst.run_dynamic_mask_head(
        jnp.asarray(want_feats), jnp.asarray(refs), jnp.asarray(params)))
    got = condinst.run_dynamic_mask_head(got_feats, t(refs), t(params)).detach().numpy()
    assert got.shape == (2, n, 16, 24)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())), rtol=0)
