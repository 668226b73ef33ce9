"""The port's fused encoder-layer tail against the JAX package.

``vnext_tpu_torch.ops.encoder_epilogue`` computes LN1(src + attn) -> FFN -> LN2
token-major with f32 LayerNorm statistics (eps 1e-6, fast variance). Its plain
version is held against the TPU kernel (``encoder_epilogue_cm``, channel-major,
interpret mode) in f32 and bf16, and the port's ``EncoderLayer`` against the JAX
``EncoderLayer`` with bridged random weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.deformable_transformer import EncoderLayer as JaxEncoderLayer
from vnext_tpu.models.deformable_transformer import encoder_reference_points as jax_enc_ref
from vnext_tpu.ops.encoder_epilogue import encoder_epilogue_cm
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.models.deformable_transformer import EncoderLayer
from vnext_tpu_torch.ops import encoder_epilogue as epi

from _torch_helpers import bf16_ulp, random_params, t

torch.set_num_threads(2)

B, C, S, F = 2, 64, 300, 128


def _inputs(seed, c=C, f=F, s=S):
    rng = np.random.RandomState(seed)
    a = rng.randn(B, s, c) * 0.5
    src = rng.randn(B, s, c)
    g1, be1 = rng.rand(c) + 0.5, rng.randn(c) * 0.1
    w1, b1 = rng.randn(f, c) / np.sqrt(c), rng.randn(f) * 0.1       # torch layout [F, C]
    w2, b2 = rng.randn(c, f) / np.sqrt(f), rng.randn(c) * 0.1       # torch layout [C, F]
    g2, be2 = rng.rand(c) + 0.5, rng.randn(c) * 0.1
    return [np.asarray(x, np.float32) for x in (a, src, g1, be1, w1, b1, w2, b2, g2, be2)]


def _jax_kernel(a, src, g1, be1, w1, b1, w2, b2, g2, be2, dtype):
    cm = lambda x: jnp.swapaxes(jnp.asarray(x, dtype), 1, 2)          # token- -> channel-major
    out = encoder_epilogue_cm(cm(a), cm(src), g1, be1, w1.T, b1, w2.T, b2, g2, be2,
                              interpret=True, ts=128)
    return np.asarray(jnp.swapaxes(out, 1, 2), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(dtype):
    args = _inputs(0)
    tdt = getattr(torch, dtype)
    got = epi.encoder_epilogue(t(args[0], tdt), t(args[1], tdt), *(t(x) for x in args[2:]))
    assert got.dtype == tdt and got.shape == (B, S, C)
    want = _jax_kernel(*args, dtype=getattr(jnp, dtype))
    got = got.float().numpy()
    if dtype == "float32":
        # f32 end to end; sums of C and F terms in other orders
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        # the inputs are the same bf16 values; the port's plain version rounds
        # both products' outputs to bf16 where the kernel rounds only the ReLU
        # activation, and both round the result: two bf16 ulps at the output
        assert np.all(np.abs(got - want) <= 2 * bf16_ulp(np.abs(want).max()))


def test_encoder_layer_matches_jax():
    shapes = ((8, 8), (4, 4))
    s = sum(h * w for h, w in shapes)
    rng = np.random.RandomState(11)
    src = rng.randn(B, s, 32).astype(np.float32)
    pos = (rng.randn(B, s, 32) * 0.1).astype(np.float32)
    vr = np.ones((B, len(shapes), 2), np.float32)
    vr[1, :, 0] = 0.75                                                 # image 1 padded on the right
    ref = np.asarray(jax_enc_ref(shapes, jnp.asarray(vr)))
    mask = np.zeros((B, s), bool)

    layer = JaxEncoderLayer(d_model=32, d_ffn=64, n_levels=2, n_heads=4, n_points=4,
                            dropout=0.0, msda_impl="jnp")
    args = (jnp.asarray(src), jnp.asarray(pos), jnp.asarray(ref), shapes, jnp.asarray(mask), False)
    params = random_params(lambda: layer.init(jax.random.PRNGKey(0), *args), seed=4)
    want = np.asarray(jax.jit(lambda p, x, po, r, m: layer.apply({"params": p}, x, po, r, shapes, m, False))(
        params, *args[:3], args[4]))

    port = EncoderLayer(32, 64, 2, 4, 4)
    load_from_jax(port, params)
    with torch.no_grad():
        got = port(t(src), t(pos), t(ref), shapes, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("f", [64, 128, 1024])
def test_chunked_product_on_packed_weights_matches_plain(f):
    """The kernel's order of work (chunk by chunk of 64 FFN columns, on the
    weights as ``pack_epilogue_weights`` lays them out for ``wgmma``), read back
    from the packed layout, equals the plain version in f32."""
    args = _inputs(3, c=256, f=f, s=37)
    a, src, g1, be1, w1, b1, w2, b2, g2, be2 = (t(x) for x in args)
    packed = epi.pack_epilogue_weights(w1, w2)
    assert packed.shape == (f // 64, 2, 64 * 256) and packed.dtype == torch.float32
    got = epi.encoder_epilogue_chunked(a, src, g1, be1, packed, b1, b2, g2, be2)
    want = epi.encoder_epilogue_plain(a, src, g1, be1, w1, b1, w2, b2, g2, be2)
    # f32 end to end; the same products summed in 64-column chunks
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("f", [64, 192])
def test_packed_weights_hold_every_element_once(f):
    c = 256
    w1 = torch.arange(f * c, dtype=torch.float64).view(f, c)
    w2 = torch.arange(f * c, 2 * f * c, dtype=torch.float64).view(c, f)
    packed = epi.pack_epilogue_weights(w1, w2)
    assert torch.equal(packed.reshape(-1).sort().values, torch.arange(2 * f * c, dtype=torch.float64))
    # the 128-byte swizzle: element (row, k) of a 64-column atom at row * 64 + 8 * ((k // 8) ^ (row % 8)) + k % 8
    rng = np.random.RandomState(f)
    for j, row, k in zip(rng.randint(0, f // 64, 20), rng.randint(0, 64, 20), rng.randint(0, c, 20)):
        pos = (k // 64) * 64 * 64 + row * 64 + 8 * ((k % 64 // 8) ^ (row % 8)) + k % 8
        assert packed[j, 0, pos] == w1[64 * j + row, k]
    for j, row, k in zip(rng.randint(0, f // 64, 20), rng.randint(0, c, 20), rng.randint(0, 64, 20)):
        assert packed[j, 1, row * 64 + 8 * ((k // 8) ^ (row % 8)) + k % 8] == w2[row, 64 * j + k]


def test_chunked_product_matches_jax_kernel_in_bf16():
    """In bf16 the chunked product rounds where the kernel does (the ReLU
    activation once, the output once), as the TPU kernel does."""
    args = _inputs(5, c=256, f=256, s=40)
    bf = torch.bfloat16
    w1, w2 = t(args[4]), t(args[6])
    packed = epi.pack_epilogue_weights(w1.to(bf), w2.to(bf))
    got = epi.encoder_epilogue_chunked(t(args[0], bf), t(args[1], bf), t(args[2]), t(args[3]), packed,
                                       t(args[5]), t(args[7]), t(args[8]), t(args[9]))
    want = _jax_kernel(*args, dtype=jnp.bfloat16)
    got = got.float().numpy()
    # both round an f32 sum of the same bf16 products once, in other orders
    assert np.all(np.abs(got - want) <= 2 * bf16_ulp(np.abs(want).max()))


def test_cpu_tensors_never_launch():
    before = epi.KERNEL.launches
    args = _inputs(1)
    epi.encoder_epilogue(*(t(x) for x in args))
    assert epi.KERNEL.launches == before
