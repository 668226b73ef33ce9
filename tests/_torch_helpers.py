"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py).

The port's tests run the same numpy inputs through the JAX package (on the CPU,
in f32) and through ``vnext_tpu_torch`` (plain PyTorch versions on CPU
tensors), and compare with stated tolerances. Kernel-vs-plain tests need a
CUDA device; they carry the ``cuda`` marker and skip without one.
"""

import jax
import numpy as np
import pytest
import torch

# tests/_tiny_idol.py's IDOL, as the port's constructor takes it
TINY_IDOL = dict(num_classes=5, hidden_dim=32, num_queries=20, nheads=4,
                 dim_feedforward=64, enc_layers=1, dec_layers=2)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run only on the card")
    return torch.device("cuda", 0)


def random_params(init_thunk, seed=0):
    """A flax param tree of the shapes ``init_thunk()`` would make, filled from
    numpy with non-degenerate values: kernels of variance 1/fan_in (so the
    sampling-offset and attention-weight kernels are not zero), small biases,
    norm scales near 1, positive BN variances. No init is compiled or run:
    only shapes are traced."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(init_thunk)["params"]

    def fill(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "weight"):
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "running_var":
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        if name in ("query_embed", "level_embed"):
            return rng.randn(*shape).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def t(a, dtype=torch.float32):
    """numpy -> CPU torch tensor."""
    return torch.from_numpy(np.array(a)).to(dtype)


def bf16_ulp(x):
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(np.asarray(x, np.float32)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)
