"""The port's MSDA implementation selector, its channel-major entry and K9's
plain version against the JAX package, on the CPU in f32.

``cfg.TPU.MSDA_IMPL`` selects the route: on the card the TPU generations v6
(``pallas``), v7 and v8 run K4 forward and K5 backward, each on a launch counter
of its own; ``jnp`` and ``xla`` run the plain version. Here every route runs the
plain version (CPU tensors), held against the JAX dispatcher with the same impl,
whose Pallas kernels run in interpret mode as the JAX package's own tests run
them: forward at rtol 1e-5 / atol 1e-6, and the gradients of value, locations
and weights at rtol 1e-3 / atol 1e-4 (tests/test_msda_pallas.py's tolerance), so
``pallas`` holds the port against the v6 backward. The inputs (the shapes of
tests/test_msda_v7.py) put samples uniformly, on integer pixels and outside
every level.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from vnext_tpu.ops.ms_deform_attn import ms_deform_attn_cm as jax_msda_cm
from vnext_tpu_torch.models.deformable_transformer import MSDeformAttnModule
from vnext_tpu_torch.models.idol import idol_kwargs_from_cfg
from vnext_tpu_torch.ops import ms_deform_attn as msda
from vnext_tpu_torch.tools import exp_dynstore

from _torch_helpers import t

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((12, 16), (6, 8), (3, 4), (2, 2))
S = sum(h * w for h, w in SHAPES)
B, M, D, L, P, Q = 2, 2, 8, 4, 2, 50
IMPLS = ("auto", "pallas_v9", "pallas", "pallas_v7", "pallas_v8", "jnp", "xla")


def _inputs(seed, mode):
    rng = np.random.RandomState(seed)
    value = rng.randn(B, S, M, D)
    if mode == "oob":
        loc = rng.rand(B, Q, M, L, P, 2) * 3.0 - 1.0
    elif mode == "integer":
        wh = np.asarray([[w, h] for h, w in SHAPES])[None, None, None, :, None, :]
        loc = (rng.randint(0, 100, (B, Q, M, L, P, 2)) % wh + 0.5) / wh
    else:
        loc = rng.rand(B, Q, M, L, P, 2)
    attn = rng.rand(B, Q, M, L, P) / (L * P)
    cot = rng.randn(B, Q, M * D)
    return [a.astype(np.float32) for a in (value, loc, attn, cot)]


@functools.lru_cache(maxsize=None)
def _jax_route(impl):
    """JAX's route and its VJP under one jit, compiled once per impl: the three
    input modes share the shapes, so the second and third reuse it."""

    def run(value, loc, attn, cot):
        out, vjp = jax.vjp(lambda v, lo, a: jax_msda(v, SHAPES, lo, a, impl=impl), value, loc, attn)
        return out, vjp(cot)

    return jax.jit(run)


@pytest.mark.parametrize("mode", ["uniform", "integer", "oob"])
@pytest.mark.parametrize("impl", IMPLS)
def test_route_and_its_gradients_match_jax(impl, mode):
    value, loc, attn, cot = _inputs(IMPLS.index(impl), mode)

    want, want_grads = _jax_route(impl)(*(jnp.asarray(a) for a in (value, loc, attn, cot)))

    leaves = [t(a).requires_grad_() for a in (value, loc, attn)]
    out = msda.ms_deform_attn_standard(leaves[0], SHAPES, leaves[1], leaves[2], impl)
    (out * t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for name, leaf, w in zip(("dvalue", "dloc", "dattn"), leaves, want_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4, err_msg=name)


def test_channel_major_entry_matches_jax():
    value, loc, attn, _ = _inputs(11, "integer")
    value_t = np.ascontiguousarray(value.reshape(B, S, M * D).transpose(0, 2, 1))   # [B, M*D, S]
    loc_cm = np.ascontiguousarray(np.moveaxis(loc, 1, 5))                            # [B, M, L, P, 2, Q]
    attn_cm = np.ascontiguousarray(np.moveaxis(attn, 1, 4))                          # [B, M, L, P, Q]
    want = np.asarray(jax_msda_cm(jnp.asarray(value_t), SHAPES, jnp.asarray(loc_cm), jnp.asarray(attn_cm),
                                  impl="pallas_v9"))
    before = msda.KERNEL_CM.launches
    for impl in ("auto", "pallas", "jnp"):
        got = msda.ms_deform_attn_cm(t(value_t), SHAPES, t(loc_cm), t(attn_cm), impl)
        assert got.shape == (B, M * D, Q)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6, err_msg=impl)
    np.testing.assert_allclose(msda.ms_deform_attn_cm_plain(t(value_t), SHAPES, t(loc_cm), t(attn_cm)).numpy(),
                               want, rtol=1e-5, atol=1e-6)
    assert msda.KERNEL_CM.launches == before


def test_cpu_routes_never_launch():
    value, loc, attn, cot = _inputs(12, "uniform")
    kernels = (msda.KERNEL_V9_FWD, msda.KERNEL_V9_BWD, msda.KERNEL_V6_FWD, msda.KERNEL_V6_BWD,
               msda.KERNEL_V7_FWD, msda.KERNEL_V8_FWD)
    before = [k.launches for k in kernels]
    for impl in IMPLS:
        leaves = [t(a).requires_grad_() for a in (value, loc, attn)]
        msda.ms_deform_attn_standard(leaves[0], SHAPES, leaves[1], leaves[2], impl).sum().backward()
    assert [k.launches for k in kernels] == before


def test_unknown_impl_raises():
    value, loc, attn, _ = _inputs(13, "uniform")
    for call in (lambda: msda.ms_deform_attn_standard(t(value), SHAPES, t(loc), t(attn), "pallas_v10"),
                 lambda: msda.ms_deform_attn_cm(t(value).flatten(2).transpose(1, 2), SHAPES,
                                                t(loc).movedim(1, 5), t(attn).movedim(1, 4), "cuda"),
                 lambda: MSDeformAttnModule(32, L, 4, P, impl="fast")):
        with pytest.raises(ValueError, match="unknown MSDA impl"):
            call()


def test_route_kernels_name_their_tpu_twin():
    for k, entry in ((msda.KERNEL_V6_FWD, "def _blocked_kernel("), (msda.KERNEL_V6_BWD, "def _bwd_la_kernel("),
                     (msda.KERNEL_V7_FWD, "def _v7_kernel("), (msda.KERNEL_V8_FWD, "def _v8_kernel("),
                     (msda.KERNEL_CM, "def ms_deform_attn_pallas_v9_cm("),
                     (exp_dynstore.KERNEL, "def kernel(x_ref, r_ref, out_ref):")):
        assert os.path.isfile(os.path.join(REPO, k.source)), k.source
        path, line = k.replaces.split(":")
        with open(os.path.join(REPO, path)) as f:
            assert f.read().splitlines()[int(line) - 1].startswith(entry), k.replaces


@pytest.mark.parametrize("cfg_name, impl", [("quick_schedules/idol_instant_test.yaml", "jnp"),
                                            ("idol/ytvis19_r50.yaml", "auto")])
def test_idol_config_carries_its_msda_impl(cfg_name, impl):
    from vnext_tpu.config import add_idol_config, get_cfg

    cfg = get_cfg()
    add_idol_config(cfg)
    cfg.merge_from_file(os.path.join(REPO, "configs", *cfg_name.split("/")))
    assert idol_kwargs_from_cfg(cfg)["msda_impl"] == impl


# ---------------------------------------------------------------- K9
def _jax_probe():
    """tools/exp_dynstore.py's ``run`` (its own check runs once as it loads)."""
    spec = importlib.util.spec_from_file_location("exp_dynstore", os.path.join(REPO, "tools", "exp_dynstore.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run


@pytest.mark.parametrize("starts", [(0, 1, 2, 0), (14, 13, 20, 3), (-1, -13, 5, 100)],
                         ids=["probe", "past_the_end", "negative"])
def test_dynstore_plain_matches_the_jax_probe(starts):
    run = _jax_probe()
    x, r = exp_dynstore.probe_inputs(starts, seed=abs(starts[1]))
    r[1] = torch.from_numpy(np.random.RandomState(5).randn(*r.shape[1:]).astype(np.float32) * 9.0)
    want = np.asarray(run(jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(r.numpy())))
    got = exp_dynstore.dynstore(x, r)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), exp_dynstore.reference(x, r))
