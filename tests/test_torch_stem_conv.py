"""The port's ResNet stem (7x7/s2 conv + frozen BN + ReLU) against the JAX package.

``vnext_tpu_torch.ops.stem_conv`` rounds the input and the kernel to bf16, sums
in f32 and returns bf16, as the TPU kernel does. Its plain version is held
against the Pallas kernel in interpret mode and against the XLA oracle; both
sides sum the same exact products (bf16 x bf16 fits f32) in different orders and
round once to bf16, so they may differ by one bf16 ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.ops.stem_conv import stem_conv7x7s2_bn_relu as jax_stem
from vnext_tpu.ops.stem_conv import stem_conv_reference
from vnext_tpu_torch.models.backbones.resnet import ResNet
from vnext_tpu_torch.ops import stem_conv as stem

from _torch_helpers import bf16_ulp, t

torch.set_num_threads(2)


def _inputs(seed, h=32, w=48):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, w, 3).astype(np.float32)
    k = (rng.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    scale = (rng.rand(64) + 0.5).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    return x, k, scale, bias


def _within_one_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    ulp = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= ulp), float(np.abs(got - want).max())


@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
def test_plain_matches_jax(oracle):
    x, k, scale, bias = _inputs(0)
    got = stem.stem_conv7x7s2_bn_relu(t(x), t(k), t(scale), t(bias))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 24, 64)
    jargs = (jnp.asarray(x), jnp.asarray(k, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias))
    if oracle == "xla":
        want = stem_conv_reference(*jargs)
    else:
        want = jax_stem(*jargs, interpret=True)
    _within_one_ulp(got.float().numpy(), want)


def test_resnet_bf16_stem_is_the_stem_op():
    """A bf16 ResNet's stem is the stem op on the folded BN; an f32 ResNet
    runs the f32 convolution, as the JAX package does off its Pallas path."""
    net = ResNet(50, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        net.conv1.weight.copy_(torch.randn(64, 3, 7, 7, generator=gen) * 0.1)
        net.bn1.weight.copy_(torch.rand(64, generator=gen) + 0.5)
        net.bn1.bias.copy_(torch.randn(64, generator=gen) * 0.1)
        net.bn1.running_mean.copy_(torch.randn(64, generator=gen) * 0.1)
        net.bn1.running_var.copy_(torch.rand(64, generator=gen) + 0.5)
    x = torch.randn(1, 16, 24, 3, generator=gen)
    scale, shift = net.bn1.folded()
    want = stem.stem_conv_plain(x, net.conv1.weight.permute(2, 3, 1, 0), scale, shift)
    got = net.stem(x)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.permute(0, 3, 1, 2), atol=0, rtol=0)


def test_odd_sizes_raise():
    x, k, scale, bias = _inputs(1, h=31, w=48)
    with pytest.raises(ValueError, match="even"):
        stem.stem_conv7x7s2_bn_relu(t(x), t(k), t(scale), t(bias))


def test_cpu_tensors_never_launch():
    before = stem.KERNEL.launches
    stem.stem_conv7x7s2_bn_relu(*(t(a) for a in _inputs(2)))
    assert stem.KERNEL.launches == before


def _im2col_kernel_order(x):
    """[B, H, W, 3] -> [B, H/2, W/2, K_PAD]: patch column ky * K_RUN_PAD + kx * 3 + ci
    holds the zero-padded input at (2 * oy + ky - 3, 2 * ox + kx - 3, ci), the
    order the kernel reduces in; the other columns are zero."""
    b, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 3, 3, 3, 3))
    cols = [xp[:, ky:ky + h:2, kx:kx + w:2, :] for ky in range(7) for kx in range(7)]
    runs = torch.stack(cols, 3).reshape(b, h // 2, w // 2, 7, stem.K_RUN)
    runs = torch.nn.functional.pad(runs, (0, stem.K_RUN_PAD - stem.K_RUN))
    return torch.nn.functional.pad(runs.flatten(3), (0, stem.K_PAD - 7 * stem.K_RUN_PAD))


@pytest.mark.parametrize("h,w", [(32, 48), (38, 70)])
def test_packed_weights_times_im2col_is_the_plain_stem(h, w):
    """The kernel's GEMM in plain PyTorch: im2col in its K order times the
    packed weights equals the plain stem, and the packing pads with zeros."""
    x, k, scale, bias = (t(a) for a in _inputs(3, h, w))
    packed = stem.pack_stem_weights(k)
    assert packed.dtype == torch.bfloat16 and packed.shape == (64, stem.K_PAD)
    taps = torch.zeros(stem.K_PAD, dtype=torch.bool)
    taps[:7 * stem.K_RUN_PAD].view(7, stem.K_RUN_PAD)[:, :stem.K_RUN] = True
    assert int(taps.sum()) == 7 * 7 * 3 and not packed[:, ~taps].any()
    cols = _im2col_kernel_order(x.to(torch.bfloat16).float())
    y = torch.relu((cols @ packed.float().t()) * scale + bias)
    # the same exact products summed in f32 in another order
    ref = torch.nn.functional.conv2d(x.to(torch.bfloat16).float().permute(0, 3, 1, 2),
                                     k.to(torch.bfloat16).float().permute(3, 2, 0, 1), stride=2, padding=3)
    ref = torch.relu(ref * scale[:, None, None] + bias[:, None, None]).permute(0, 2, 3, 1)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
    want = stem.stem_conv_plain(x, k, scale, bias)
    _within_one_ulp(y.to(torch.bfloat16).float().numpy(), want.float().numpy())
