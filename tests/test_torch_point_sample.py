"""The port's point sampling (``vnext_tpu_torch.ops.point_sample``) against the
JAX package's (``vnext_tpu.ops.point_sample``), on the CPU in f32.

- ``point_sample`` at coordinates inside and outside [0, 1] (a corner outside
  the map adds zero): within 1e-6 absolute.
- The uncertain pick on JAX's own uniform draws (its key split as its function
  splits it): the whole of ``get_uncertain_point_coords_with_randomness``
  equal, coordinate for coordinate.
- ``sampled_mask_losses`` at JAX's coordinates: the port's losses at given
  coordinates within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vnext_tpu.ops import point_sample as jps
from vnext_tpu_torch.ops import point_sample as ps

N, H, W = 6, 24, 40


def _logits(seed):
    return np.random.RandomState(seed).randn(N, H, W).astype(np.float32) * 3


def test_point_sample_matches_jax_inside_and_outside():
    rng = np.random.RandomState(0)
    x = _logits(1)
    coords = (rng.rand(N, 500, 2) * 1.4 - 0.2).astype(np.float32)      # ~30% outside [0, 1]
    coords[:, :4] = [[0, 0], [1, 1], [-0.01, 0.5], [0.5, 1.01]]       # the edges
    want = np.asarray(jps.point_sample(jnp.asarray(x), jnp.asarray(coords)))
    got = ps.point_sample(torch.from_numpy(x), torch.from_numpy(coords)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(want).max() > 1


def test_uncertain_pick_equals_jax_on_its_draws():
    x = _logits(2)
    num_points, key = 96, jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(jps.get_uncertain_point_coords_with_randomness, static_argnums=1)(
        jnp.asarray(x), num_points, rng=key))
    r1, r2 = jax.random.split(key)
    candidates = np.array(jax.random.uniform(r1, (N, num_points * 3, 2)))
    extra = np.array(jax.random.uniform(r2, (N, num_points - 72, 2)))
    picked = ps.uncertain_coords(torch.from_numpy(x), torch.from_numpy(candidates), 72)
    got = torch.cat([picked, torch.from_numpy(extra)], 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_losses_at_given_coordinates_match_jax():
    rng = np.random.RandomState(3)
    src = _logits(4)
    tgt = (rng.rand(N, H, W) > 0.6).astype(np.float32)
    valid = np.asarray([1, 1, 0, 1, 0, 1], bool)
    num = np.float32(valid.sum())
    key = jax.random.PRNGKey(9)
    coords = np.array(jax.jit(jps.get_uncertain_point_coords_with_randomness, static_argnums=1)(
        jnp.asarray(src), 200, rng=key))
    want = jax.jit(jps.sampled_mask_losses, static_argnames="num_points")(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid), jnp.asarray(num), num_points=200, rng=key)
    got = ps.mask_losses_at(torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(coords),
                            torch.from_numpy(valid), torch.tensor(num))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


def test_sampled_losses_draw_from_the_generator():
    src = torch.from_numpy(_logits(6)).requires_grad_()
    tgt = torch.from_numpy((np.random.RandomState(7).rand(N, H, W) > 0.5).astype(np.float32))
    valid, num = torch.ones(N, dtype=torch.bool), torch.tensor(float(N))

    def run(seed):
        return ps.sampled_mask_losses(src, tgt, valid, num, num_points=64,
                                      generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert [float(v.detach()) for v in a] == [float(v.detach()) for v in b]
    assert [float(v.detach()) for v in a] != [float(v.detach()) for v in c]
    sum(a).backward()
    assert torch.isfinite(src.grad).all() and src.grad.abs().sum() > 0
