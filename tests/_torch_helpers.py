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


# ---------------------------------------------------------------- training
TRAIN_SIZES = np.asarray([[64, 85], [56, 96]], np.int32)   # valid (h, w) of 2 clips


def tiny_batch(seed, n_valid=(3, 2)):
    """A seeded collated batch in the loader's format (``batch_to_model_inputs``
    reads it) for tests/_tiny_idol.py's IDOL: len(n_valid) clips of key + ref
    frames at 64x96 with K padded instance slots; clip i has n_valid[i]
    instances, and its reference frame lacks the last of them."""
    from _tiny_idol import H, K, W

    rng = np.random.RandomState(seed)
    b = len(n_valid)
    batch = {}
    for prefix in ("key", "ref"):
        boxes = np.zeros((b, K, 4), np.float32)
        boxes[..., :2] = rng.rand(b, K, 2) * 0.5 + 0.25
        boxes[..., 2:] = rng.rand(b, K, 2) * 0.3 + 0.1
        masks = np.zeros((b, K, H // 4, W // 4), bool)
        valid = np.zeros((b, K), bool)
        for i, n in enumerate(n_valid):
            n = n - 1 if prefix == "ref" and n > 1 else n
            valid[i, :n] = True
            for j in range(n):
                masks[i, j, 2 + 2 * j: 9 + 2 * j, 3 + j: 12 + 2 * j] = True
        batch[f"{prefix}_image"] = rng.randint(0, 256, (b, H, W, 3)).astype(np.uint8)
        batch[f"{prefix}_size"] = TRAIN_SIZES[:b].copy()
        batch[f"{prefix}_labels"] = rng.randint(0, 5, (b, K)).astype(np.int32)
        batch[f"{prefix}_boxes"] = boxes
        batch[f"{prefix}_masks_s4"] = masks
        batch[f"{prefix}_valid"] = valid
        batch[f"{prefix}_inst_id"] = np.where(valid, np.arange(K)[None], -1).astype(np.int32)
    return batch


def ytvis19_r50_cfg():
    """The JAX package's config for configs/idol/ytvis19_r50.yaml (the port
    reads its SOLVER / MODEL / TPU nodes by attribute)."""
    import os

    from vnext_tpu.config import add_idol_config, get_cfg

    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs", "idol", "ytvis19_r50.yaml"))
    return cfg


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
