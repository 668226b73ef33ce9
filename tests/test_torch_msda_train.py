"""The port's MSDA standard (training) entry against the JAX package, on the CPU.

``vnext_tpu_torch.ops.ms_deform_attn.ms_deform_attn_standard`` with
``impl="pallas_v9"`` takes normalized f32 locations and softmaxed weights, as
``ms_deform_attn_pallas_v9`` does, and carries a gradient to value, locations
and weights (K4 / K5 on the card, the plain core and its autograd here). Held against:

- ``ms_deform_attn_core_jnp`` and ``jax.grad`` of it under a seeded cotangent,
  with uniform samples, samples exactly on pixel centres (where the corner-wise
  derivative and the tent's sign differ), samples outside every level, and
  zero-padded value rows;
- the Pallas kernel itself in interpret mode, forward and ``_backward_v9``, at
  one tiny shape, as tests/test_msda_v9_bwd.py runs it;
- ``torch.autograd.gradcheck`` of the autograd function in f64;
- the JAX ``MSDeformAttnModule`` in training (token-major standard path):
  output and gradients of the box form, with bridged random weights.
All f32 unless stated.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.models.deformable_transformer import MSDeformAttnModule as JaxMSDA
from vnext_tpu.ops.ms_deform_attn import ms_deform_attn_core_jnp
from vnext_tpu.ops.ms_deform_attn_pallas_v9 import ms_deform_attn_pallas_v9
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.models.deformable_transformer import MSDeformAttnModule
from vnext_tpu_torch.ops import ms_deform_attn as msda

from _torch_helpers import random_params, t

torch.set_num_threads(2)

SHAPES = ((6, 8), (3, 4))
B, Q, M, D, P = 2, 30, 2, 8, 2
# f32 sums of the same products in other orders; dloc carries the level's width
# (up to 8 here) times sums of ~4 * D products
TOL = 1e-5
TOL_DLOC = 1e-4


def _pad_rows(shapes):
    """Token indices of the last column of every level (as a padded width pads)."""
    idx, start = [], 0
    for h, w in shapes:
        idx.append(start + np.arange(h) * w + (w - 1))
        start += h * w
    return np.concatenate(idx)


def _inputs(seed, mode, shapes=SHAPES, b=B, q=Q):
    rng = np.random.RandomState(seed)
    s, l = sum(h * w for h, w in shapes), len(shapes)
    value = rng.randn(b, s, M, D).astype(np.float32)
    if mode == "padded":
        value[:, _pad_rows(shapes)] = 0.0
    if mode == "oob":
        loc = rng.rand(b, q, M, l, P, 2) * 3.0 - 1.0
    elif mode == "integer":
        loc = np.empty((b, q, M, l, P, 2))
        for li, (h, w) in enumerate(shapes):
            loc[:, :, :, li, :, 0] = (rng.randint(0, w, (b, q, M, P)) + 0.5) / w
            loc[:, :, :, li, :, 1] = (rng.randint(0, h, (b, q, M, P)) + 0.5) / h
    else:
        loc = rng.rand(b, q, M, l, P, 2)
    attn = rng.rand(b, q, M, l, P) / (l * P)
    cot = rng.randn(b, q, M * D)
    return [a.astype(np.float32) for a in (value, loc, attn, cot)]


@functools.lru_cache(maxsize=None)
def _jax_output_and_grads(fn, shapes):
    """fn's output and the gradients of sum(output * cot), under one jit per
    (fn, shapes): run op by op, each primitive compiles a program of its own."""

    def run(v, lo, a, cot):
        def loss(v, lo, a):
            return jnp.sum(fn(v, shapes, lo, a) * cot)

        return fn(v, shapes, lo, a), jax.grad(loss, argnums=(0, 1, 2))(v, lo, a)

    return jax.jit(run)


def _jax_grads(fn, shapes, value, loc, attn, cot):
    out, grads = _jax_output_and_grads(fn, shapes)(value, loc, attn, cot)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _port_grads(shapes, value, loc, attn, cot):
    leaves = [t(a).requires_grad_() for a in (value, loc, attn)]
    out = msda.ms_deform_attn_standard(leaves[0], shapes, leaves[1], leaves[2], "pallas_v9")
    (out * t(cot)).sum().backward()
    return [out.detach().numpy()] + [x.grad.numpy() for x in leaves]


def _check(got, want):
    for name, g, w in zip(("out", "dvalue", "dloc", "dattn"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=TOL_DLOC if name == "dloc" else TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("mode", ["uniform", "integer", "oob", "padded"])
def test_plain_and_its_gradients_match_jnp_oracle(mode):
    args = _inputs(3, mode)
    _check(_port_grads(SHAPES, *args), _jax_grads(ms_deform_attn_core_jnp, SHAPES, *args))


def test_padded_rows_get_gradient_but_give_nothing():
    value, loc, attn, cot = _inputs(4, "padded")
    noisy = value.copy()
    noisy[:, _pad_rows(SHAPES)] = 1e3
    a, b = _port_grads(SHAPES, value, loc, attn, cot), _port_grads(SHAPES, noisy, loc, attn, cot)
    assert np.abs(a[0] - b[0]).max() > 1.0               # the rows are read ...
    np.testing.assert_array_equal(a[1], b[1])            # ... and dvalue does not depend on them


def test_matches_the_pallas_v9_kernel_in_interpret_mode():
    """The TPU kernel's forward and its custom VJP (``_backward_v9``) at one tiny shape."""
    shapes = ((12, 16), (6, 8), (3, 4), (2, 2))
    args = _inputs(5, "integer", shapes=shapes, b=1, q=20)
    _check(_port_grads(shapes, *args), _jax_grads(ms_deform_attn_pallas_v9, shapes, *args))


def test_autograd_function_gradcheck_f64():
    value, loc, attn, _ = _inputs(6, "uniform", b=1, q=4)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in (value, loc, attn)]
    assert torch.autograd.gradcheck(
        lambda v, lo, a: msda.ms_deform_attn_standard(v, SHAPES, lo, a, "pallas_v9"), leaves, eps=1e-6, atol=1e-5)


def test_module_train_path_and_gradients_match_jax():
    """Decoder box form: the port's module in train mode against the JAX module's
    token-major path, output and the gradients of every parameter and input."""
    rng = np.random.RandomState(7)
    c, l, s = M * D, len(SHAPES), sum(h * w for h, w in SHAPES)
    query = rng.randn(B, 12, c).astype(np.float32)
    src = rng.randn(B, s, c).astype(np.float32)
    ref = np.concatenate([rng.rand(B, 12, l, 2), rng.rand(B, 12, l, 2) * 0.5 + 0.05], -1).astype(np.float32)
    mask = np.zeros((B, s), bool)
    mask[:, _pad_rows(SHAPES)] = True
    cot = rng.randn(B, 12, c).astype(np.float32)

    jmod = JaxMSDA(d_model=c, n_levels=l, n_heads=M, n_points=P, impl="jnp")
    params = random_params(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(query), jnp.asarray(ref),
                                             jnp.asarray(src), SHAPES, jnp.asarray(mask)), seed=9)

    def loss(p, qy, sr):
        out = jmod.apply({"params": p}, qy, jnp.asarray(ref), sr, SHAPES, jnp.asarray(mask))
        return jnp.sum(out * cot), out

    (_, want), (g_params, g_query, g_src) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(query), jnp.asarray(src))

    mod = MSDeformAttnModule(c, l, M, P).train()
    load_from_jax(mod, params)
    tq, ts = t(query).requires_grad_(), t(src).requires_grad_()
    got = mod(tq, t(ref), ts, SHAPES, torch.from_numpy(mask))
    (got * t(cot)).sum().backward()
    # one more f32 product on each side of the core (the projections)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(g_query), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(g_src), atol=1e-4, rtol=0)
    want_params = params_from_jax(jax.tree.map(np.asarray, g_params))
    for n, p in mod.named_parameters():
        w = want_params[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-4 * max(1.0, np.abs(w).max()), rtol=0, err_msg=n)


def test_cpu_tensors_never_launch():
    before = (msda.KERNEL_V9_FWD.launches, msda.KERNEL_V9_BWD.launches)
    _port_grads(SHAPES, *_inputs(8, "uniform"))
    assert (msda.KERNEL_V9_FWD.launches, msda.KERNEL_V9_BWD.launches) == before


def test_train_kernels_name_their_source_and_tpu_twin():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for k, entry in ((msda.KERNEL_V9_FWD, "def _forward_v9("), (msda.KERNEL_V9_BWD, "def _v9_bwd_kernel(")):
        assert os.path.isfile(os.path.join(repo, k.source))
        path, line = k.replaces.split(":")
        with open(os.path.join(repo, path)) as f:
            assert f.read().splitlines()[int(line) - 1].startswith(entry), k.replaces
