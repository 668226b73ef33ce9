"""The port's exact assignment (``vnext_tpu_torch.ops.hungarian``: scipy on the
host) against the JAX package's Jonker-Volgenant loop
(``vnext_tpu.ops.hungarian``), on the CPU.

- On seeded random [K, Q] costs (K in {3, 8, 48}, Q in {10, 100, 300}, K <= Q,
  about a quarter of the rows invalid) the assignment equals JAX's exactly:
  a random f32 cost has one optimum.
- On costs with exact ties (integers 0-3) both reach the same objective and
  leave the same rows unassigned; the assignments themselves differ (in 2 of
  4 cases at K 8, Q 10 and in 4 of 4 at K 48, Q 100 on these seeds): where
  the optimum is not unique, scipy and the JV loop pick different ones.
- ``hungarian_match``'s three outputs are JAX's, and ``assign_batched`` over
  [L, B, K, Q] equals slice-by-slice ``hungarian``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.ops.hungarian import hungarian as jax_hungarian
from vnext_tpu.ops.hungarian import hungarian_match as jax_hungarian_match
from vnext_tpu_torch.ops.hungarian import assign_batched, hungarian, hungarian_match

SHAPES = [(k, q) for k, q in itertools.product((3, 8, 48), (10, 100, 300)) if k <= q]
N_CASES = 4


def _cases(k, q, seed, ties=False):
    rng = np.random.RandomState(seed)
    if ties:
        cost = rng.randint(0, 4, (N_CASES, k, q)).astype(np.float32)
    else:
        cost = rng.randn(N_CASES, k, q).astype(np.float32)
    valid = rng.rand(N_CASES, k) > 0.25
    valid[0] = True                       # one case with every row valid
    return cost, valid


def _jax(cost, valid):
    return np.asarray(jax.jit(jax.vmap(jax_hungarian))(jnp.asarray(cost), jnp.asarray(valid)))


def _objective(cost, assignment):
    rows = np.flatnonzero(assignment >= 0)
    return float(cost[rows, assignment[rows]].astype(np.float64).sum())


@pytest.mark.parametrize("k,q", SHAPES, ids=[f"K{k}-Q{q}" for k, q in SHAPES])
def test_assignment_equals_jax(k, q):
    cost, valid = _cases(k, q, seed=k * 1000 + q)
    want = _jax(cost, valid)
    got = assign_batched(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == -1).all() and (got[valid] >= 0).all()
    for g in got:                        # distinct queries
        assert len(set(g[g >= 0])) == int((g >= 0).sum())


@pytest.mark.parametrize("k,q", [(8, 10), (48, 100)], ids=["K8-Q10", "K48-Q100"])
def test_ties_reach_jax_objective(k, q):
    cost, valid = _cases(k, q, seed=7 + k, ties=True)
    want = _jax(cost, valid)
    got = assign_batched(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    for c, g, w in zip(cost, got, want):
        assert _objective(c, g) == _objective(c, w)
    np.testing.assert_array_equal(got >= 0, want >= 0)


def test_hungarian_match_equals_jax():
    cost, valid = _cases(8, 20, seed=3)
    match = jax.jit(jax_hungarian_match)
    for c, v in zip(cost, valid):
        want = match(jnp.asarray(c), jnp.asarray(v))
        got = hungarian_match(torch.from_numpy(c), torch.from_numpy(v))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_batched_equals_slices_and_keeps_the_device():
    rng = np.random.RandomState(11)
    cost = torch.from_numpy(rng.randn(3, 2, 6, 30).astype(np.float32))
    valid = torch.from_numpy(rng.rand(3, 2, 6) > 0.3)
    got = assign_batched(cost, valid)
    assert got.shape == (3, 2, 6) and got.dtype == torch.int64 and got.device == cost.device
    for i, j in itertools.product(range(3), range(2)):
        np.testing.assert_array_equal(got[i, j].numpy(), hungarian(cost[i, j], valid[i, j]).numpy())
    empty = assign_batched(cost, torch.zeros_like(valid))
    assert (empty == -1).all()
