"""The gradient of the port's stem op (K2's autograd function) against the JAX
package's custom VJP, on the CPU.

The JAX stem (``stem_conv7x7s2_bn_relu``, its Pallas kernel in interpret mode
here) linearizes ``_stem_ref_f32``: an f32 convolution of the input with the
bf16 kernel. The port's backward is the autograd of the same function
(``stem_conv_ref_f32``) on both devices; the CPU route's forward is the plain
version. The kernel enters JAX as bf16, so its gradient comes back rounded to
bf16 on both sides; the other gradients are f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vnext_tpu.ops.stem_conv import stem_conv7x7s2_bn_relu as jax_stem
from vnext_tpu_torch.models.backbones.resnet import ResNet
from vnext_tpu_torch.models.layers import init_weights
from vnext_tpu_torch.ops import stem_conv as stem

from _torch_helpers import bf16_ulp, t

torch.set_num_threads(2)


def _inputs(seed, h=16, w=24):
    rng = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (
        rng.randn(2, h, w, 3), rng.randn(7, 7, 3, 64) * 0.1, rng.rand(64) + 0.5,
        rng.randn(64) * 0.1, rng.randn(2, h // 2, w // 2, 64))]


def test_gradients_match_jax_vjp():
    x, k, scale, bias, cot = _inputs(0)
    jargs = (jnp.asarray(x), jnp.asarray(k, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias))
    out, vjp = jax.vjp(lambda *a: jax_stem(*a, interpret=True), *jargs)
    want = vjp(jnp.asarray(cot, jnp.bfloat16))

    leaves = [t(a).requires_grad_() for a in (x, k, scale, bias)]
    got = stem.stem_conv7x7s2_bn_relu(*leaves)
    got.backward(t(cot).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # dx, dscale, dbias: f32 sums of the same products in other orders
    for name, leaf, w in zip(("x", "scale", "bias"), (leaves[0], leaves[2], leaves[3]),
                             (want[0], want[2], want[3])):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0, err_msg=name)
    # dkernel: the same f32 sums, each rounded to bf16 once: one bf16 ulp
    dk, wk = leaves[1].grad.numpy(), np.asarray(want[1], np.float32)
    assert np.all(np.abs(dk - wk) <= bf16_ulp(np.maximum(np.abs(dk), np.abs(wk))))
    assert np.array_equal(dk, dk.astype(jnp.bfloat16).astype(np.float32))


def test_bf16_resnet_stem_carries_gradient_to_the_frozen_bn():
    """The stem runs the op on the folded frozen BN; its gradient reaches the
    BN's four tensors, which the gradient-norm clip counts."""
    net = ResNet(50, dtype=torch.bfloat16)
    init_weights(net, 0)
    y = net.stem(torch.randn(1, 16, 24, 3, generator=torch.Generator().manual_seed(0)))
    y.float().square().sum().backward()
    for p in (net.conv1.weight, net.bn1.weight, net.bn1.bias, net.bn1.running_mean, net.bn1.running_var):
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0
