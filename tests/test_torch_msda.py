"""The port's multi-scale deformable attention against the JAX package.

``vnext_tpu_torch.ops.ms_deform_attn`` keeps the fused entry semantics of the
TPU kernel (raw offsets + reference points + raw logits in; locations and the
softmax over L*P formed inside). Its plain version is held against the JAX
fused Pallas kernel (``ms_deform_attn_pallas_v9_cm_fused``, interpret mode on
the CPU, as tests/test_msda_v9.py runs it) and against the jnp oracle, for point
and box references, samples far outside every level, samples exactly on pixel
centres, and zeroed padding tokens. ``MSDeformAttnModule`` is held against the
JAX module at ``impl="pallas_v9"`` with bridged random weights. All in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.deformable_transformer import MSDeformAttnModule as JaxMSDA
from vnext_tpu.ops.ms_deform_attn import ms_deform_attn_core_jnp
from vnext_tpu.ops.ms_deform_attn_pallas_v9 import ms_deform_attn_pallas_v9_cm_fused
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax
from vnext_tpu_torch.models.deformable_transformer import MSDeformAttnModule
from vnext_tpu_torch.ops import ms_deform_attn as msda

from _torch_helpers import random_params, t

torch.set_num_threads(2)

SHAPES = ((12, 16), (6, 8), (3, 4), (2, 2))
S = sum(h * w for h, w in SHAPES)
L = len(SHAPES)
B, M, D, P = 2, 2, 8, 2
WH = np.asarray([[w, h] for h, w in SHAPES], np.float32)     # [L, 2]

# f32 throughout; the port forms x = ref*w - 0.5 + off exactly as the fused TPU
# kernel does, so the two agree to f32 rounding of the sums
TOL_KERNEL = 1e-5
# the oracle forms loc = ref + off/w first, which moves coordinates by f32
# rounding (~1e-6 px at these level sizes); the output moves by that times the
# value's slope (randn per pixel)
TOL_ORACLE = 1e-5


def _pad_tokens():
    """Token indices of the last column of every level (as a padded width pads)."""
    idx, start = [], 0
    for h, w in SHAPES:
        idx.append(start + np.arange(h) * w + (w - 1))
        start += h * w
    return np.concatenate(idx)


def _inputs(seed, q, box):
    rng = np.random.RandomState(seed)
    value = rng.randn(B, S, M, D).astype(np.float32)
    value[:, _pad_tokens()] = 0.0
    if box:
        ref = np.concatenate([rng.rand(B, q, L, 2), rng.rand(B, q, L, 2) * 0.5 + 0.05], -1)
    else:
        # a third of the queries sit on pixel centres of every level; with the
        # integer offsets of point 0 their samples land exactly on pixels
        ref = rng.rand(B, q, L, 2)
        cols = rng.randint(0, 1000, (B, q, L, 2))
        ref[:, : q // 3] = ((cols % WH[None, None, :, :].astype(int) + 0.5) / WH)[:, : q // 3]
    off = rng.randn(B, q, M, L, P, 2) * 3.0
    off[..., 0, :] = np.round(off[..., 0, :])
    far = rng.rand(B, q, M, L, P) < 0.1                        # far outside every level
    off[far] = rng.choice([-60.0, 60.0], size=(int(far.sum()), 2))
    logits = rng.randn(B, q, M, L * P) * 2.0
    return [a.astype(np.float32) for a in (value, off, ref, logits)]


def _port(value, off, ref, logits):
    out = msda.ms_deform_attn(t(value), SHAPES, t(off), t(ref), t(logits))
    return out.numpy()


@jax.jit
def _oracle_jax(value, off, ref, logits):
    q = off.shape[1]
    w = jax.nn.softmax(jnp.asarray(logits), -1).reshape(B, q, M, L, P)
    r = ref[:, :, None, :, None]
    if ref.shape[-1] == 2:
        loc = r + off / WH[:, None, :]
    else:
        loc = r[..., :2] + off / P * r[..., 2:] * 0.5
    return ms_deform_attn_core_jnp(jnp.asarray(value), SHAPES, jnp.asarray(loc), w)


def _oracle(*args):
    """The jnp oracle under one jit (op by op, each primitive compiles a program of its own)."""
    return np.asarray(_oracle_jax(*args))


@jax.jit
def _jax_fused_kernel_jax(value, off, ref, logits):
    q = off.shape[1]
    valueT = jnp.swapaxes(jnp.asarray(value).reshape(B, S, M * D), 1, 2)
    if ref.shape[-1] == 4:
        # the box form pre-scales the offsets (deformable_transformer.py:114-119)
        off = off * ref[:, :, None, :, None, 2:] * WH[:, None, :] * (0.5 / P)
        ref = ref[..., :2]
    out = ms_deform_attn_pallas_v9_cm_fused(
        valueT, SHAPES, jnp.moveaxis(jnp.asarray(off), 1, 5), jnp.moveaxis(jnp.asarray(ref), 1, 3),
        jnp.moveaxis(jnp.asarray(logits).reshape(B, q, M, L, P), 1, 4), attn_is_logits=True,
    )
    return jnp.swapaxes(out, 1, 2)


def _jax_fused_kernel(*args):
    """The TPU kernel's fused entry, fed as the JAX module feeds it, under one jit."""
    return np.asarray(_jax_fused_kernel_jax(*args))


@pytest.mark.parametrize("box", [False, True], ids=["point", "box"])
def test_plain_matches_jax_fused_kernel(box):
    args = _inputs(1 + box, 40, box)
    np.testing.assert_allclose(_port(*args), _jax_fused_kernel(*args), atol=TOL_KERNEL, rtol=0)


@pytest.mark.parametrize("box", [False, True], ids=["point", "box"])
def test_plain_matches_jnp_oracle(box):
    args = _inputs(3 + box, 60, box)
    np.testing.assert_allclose(_port(*args), _oracle(*args), atol=TOL_ORACLE, rtol=0)


def test_padding_tokens_contribute_nothing():
    value, off, ref, logits = _inputs(5, 30, False)
    noisy = value.copy()
    noisy[:, _pad_tokens()] = 1e3
    assert np.abs(_port(noisy, off, ref, logits) - _port(value, off, ref, logits)).max() > 1.0
    # and the module zeroes them from the padding mask before sampling
    mod = MSDeformAttnModule(M * D, L, M, P)
    state = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(0)) * 0.2
             for k, v in mod.state_dict().items()}
    mod.load_state_dict(state)
    mask = torch.zeros(B, S, dtype=torch.bool)
    mask[:, _pad_tokens()] = True
    src = torch.randn(B, S, M * D)
    src2 = src.clone()
    src2[:, _pad_tokens()] = 1e3
    query = torch.randn(B, 30, M * D)
    a = mod(query, t(ref), src, SHAPES, mask)
    b = mod(query, t(ref), src2, SHAPES, mask)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("box", [False, True], ids=["encoder", "decoder"])
def test_module_matches_jax_module(box):
    """Port MSDeformAttnModule == JAX MSDeformAttnModule(impl="pallas_v9"),
    token-major, bridged random weights with non-zero offset kernels."""
    rng = np.random.RandomState(7)
    c = M * D
    q = 12 if box else S
    ref = _inputs(8, q, box)[2]
    query = rng.randn(B, q, c).astype(np.float32)
    src = rng.randn(B, S, c).astype(np.float32)
    mask = np.zeros((B, S), bool)
    mask[:, _pad_tokens()] = True

    jmod = JaxMSDA(d_model=c, n_levels=L, n_heads=M, n_points=P, impl="pallas_v9")
    args = (jnp.asarray(query), jnp.asarray(ref), jnp.asarray(src), SHAPES, jnp.asarray(mask))
    params = random_params(lambda: jmod.init(jax.random.PRNGKey(0), *args), seed=9)
    want = np.asarray(jax.jit(lambda p, qy, r, sr, m: jmod.apply({"params": p}, qy, r, sr, SHAPES, m))(
        params, *args[:3], args[4]))

    mod = MSDeformAttnModule(c, L, M, P)
    load_from_jax(mod, params)
    got = mod(t(query), t(ref), t(src), SHAPES, torch.from_numpy(mask)).detach().numpy()
    # one more f32 product on each side of the core (the projections)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_cpu_tensors_never_launch():
    before = msda.KERNEL.launches
    _port(*_inputs(11, 10, False))
    assert msda.KERNEL.launches == before


def test_other_devices_raise():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    device gets an error, not the plain version."""
    value, off, ref, logits = (torch.empty(a.shape, device="meta") for a in _inputs(12, 10, False))
    with pytest.raises(ValueError, match="no implementation"):
        msda.ms_deform_attn(value, SHAPES, off, ref, logits)
