"""The kernels as operators (torch.ops.vnext.*), export and analysis, on the CPU.

Each operator passes ``torch.library.opcheck`` (schema, fake function, autograd
registration, and the fake function against its CPU implementation, the plain
version); each FLOP formula matches a hand count. A tiny IDOL and a tiny
SeqFormer (bf16, the fused inference path) export with ``torch.export``: the
graph holds the operators and none of the plain versions, and the program
loaded from its ``.pt2`` gives the eager model's outputs bit for bit.
``parameter_count`` / ``parameter_count_table`` of a tiny IDOL equal the JAX
package's on its flax tree, and ``flop_count`` / ``activation_count`` equal
JAX's (XLA's cost analysis, its jaxpr) on a convolution and a dense layer,
where both count 2 operations per multiply-add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vnext_tpu.models import IDOL as JaxIDOL
from vnext_tpu.utils import analysis as jax_analysis
from vnext_tpu_torch.export import (export_program, load_exported, plain_versions_refused, save_exported,
                                    vnext_op_counts)
from vnext_tpu_torch.models.idol import IDOL
from vnext_tpu_torch.models.layers import init_weights
from vnext_tpu_torch.models.seqformer import SeqFormer
from vnext_tpu_torch.ops import encoder_epilogue, ms_deform_attn, stem_conv
from vnext_tpu_torch.tools.export_model import example_inputs, inference_fn
from vnext_tpu_torch.utils import analysis
from torch.utils.flop_counter import FlopCounterMode

from _torch_helpers import TINY_IDOL

LEVELS = ((6, 8), (3, 4))
B, Q, M, D, L, P = 2, 5, 2, 4, 2, 2


def _op_args(seed=0):
    """CPU arguments of each operator at a small shape, f32."""
    g = torch.Generator().manual_seed(seed)
    s = sum(h * w for h, w in LEVELS)
    flat = ms_deform_attn.flat_shapes(LEVELS)
    value = torch.randn(B, s, M, D, generator=g)
    off = torch.randn(B, Q, M, L, P, 2, generator=g)
    ref = torch.rand(B, Q, L, 2, generator=g)
    logits = torch.randn(B, Q, M, L * P, generator=g)
    loc = torch.rand(B, Q, M, L, P, 2, generator=g)
    attn = torch.softmax(torch.randn(B, Q, M, L, P, generator=g), -1)
    c, f, n = 64, 128, 7
    epi = [torch.randn(1, n, c, generator=g), torch.randn(1, n, c, generator=g), 1 + 0.1 * torch.randn(c, generator=g),
           0.1 * torch.randn(c, generator=g), torch.randn(f, c, generator=g) / 8, 0.1 * torch.randn(f, generator=g),
           torch.randn(c, f, generator=g) / 11, 0.1 * torch.randn(c, generator=g),
           1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)]
    stem = [torch.randn(2, 10, 12, 3, generator=g), 0.1 * torch.randn(7, 7, 3, 64, generator=g),
            torch.rand(64, generator=g) + 0.5, 0.1 * torch.randn(64, generator=g)]
    return {
        "msda_fwd": (value, off, ref, logits, flat),
        "msda_fwd_loc": (value, loc, attn, flat, "pallas_v9"),
        "encoder_epilogue": tuple(epi),
        "stem_conv": tuple(stem),
    }


@pytest.mark.parametrize("name", ["msda_fwd", "msda_fwd_loc", "encoder_epilogue", "stem_conv"])
def test_operator_passes_opcheck_and_runs_the_plain_version(name):
    op = getattr(torch.ops.vnext, name)
    args = _op_args()[name]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    plain = {"msda_fwd": lambda v, o, r, lg, f: ms_deform_attn.ms_deform_attn_plain(v, LEVELS, o, r, lg),
             "msda_fwd_loc": lambda v, lc, a, f, i: ms_deform_attn.ms_deform_attn_core_plain(v, LEVELS, lc, a),
             "encoder_epilogue": encoder_epilogue.encoder_epilogue_plain,
             "stem_conv": stem_conv.stem_conv_plain}[name]
    assert torch.equal(op(*args), plain(*args))


def test_operators_fakes_check_shapes():
    args = _op_args()
    bad = {"msda_fwd": (args["msda_fwd"][0], args["msda_fwd"][1][:, :, :1], *args["msda_fwd"][2:]),
           "msda_fwd_loc": (*args["msda_fwd_loc"][:3], [6, 8], "pallas_v9"),
           "encoder_epilogue": (args["encoder_epilogue"][0][:, :3], *args["encoder_epilogue"][1:]),
           "stem_conv": (args["stem_conv"][0][:, :9], *args["stem_conv"][1:])}
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        for name, a in bad.items():
            fake = [mode.from_tensor(t) if isinstance(t, torch.Tensor) else t for t in a]
            with pytest.raises(ValueError):
                getattr(torch.ops.vnext, name)(*fake)
    with pytest.raises(ValueError, match="plain version"):
        with FakeTensorMode() as mode:
            a = args["msda_fwd_loc"]
            torch.ops.vnext.msda_fwd_loc(*[mode.from_tensor(t) for t in a[:3]], a[3], "jnp")


def test_flop_formulas_match_hand_counts():
    args = _op_args()
    hand = {
        # each query, head and sample: 4 corners, each a multiply-add into D channels
        "msda_fwd": 2 * B * Q * M * L * P * 4 * D,
        "msda_fwd_loc": 2 * B * Q * M * L * P * 4 * D,
        # [7, 64] x [64, 128] and [7, 128] x [128, 64]
        "encoder_epilogue": 2 * 7 * 64 * 128 * 2,
        # 2 x 5 x 6 outputs of 64 channels, 7 * 7 * 3 taps each
        "stem_conv": 2 * (2 * 5 * 6 * 64) * 7 * 7 * 3,
    }
    for name, want in hand.items():
        counter = FlopCounterMode(display=False)
        with counter:
            getattr(torch.ops.vnext, name)(*args[name])
        assert counter.get_total_flops() == want, name
    # the same counts through the analysis tool, by operator
    cost = analysis.flop_count(lambda *a: torch.ops.vnext.stem_conv(*a), *args["stem_conv"])
    assert cost == {"flops": float(hand["stem_conv"]), "by_operator": {"vnext.stem_conv": hand["stem_conv"]}}


def test_flop_and_activation_counts_equal_jax_on_conv_and_dense():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, 16, 3).astype(np.float32)            # NHWC
    k = rng.randn(3, 3, 3, 8).astype(np.float32)               # HWIO
    w = rng.randn(10 * 14 * 8, 5).astype(np.float32)

    def jax_fn(x, k, w):
        y = jax.lax.conv_general_dilated(x, k, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return y.reshape(2, -1) @ w

    def port_fn(x, k, w):
        y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
        return y.reshape(2, -1) @ w

    jargs = [jnp.asarray(a) for a in (x, k, w)]
    targs = [torch.from_numpy(a) for a in (x, k, w)]
    mac = 2 * 10 * 14 * 8 * 27 + 2 * 10 * 14 * 8 * 5
    assert analysis.flop_count(port_fn, *targs)["flops"] == jax_analysis.flop_count(jax_fn, *jargs)["flops"] == 2 * mac
    assert analysis.activation_count(port_fn, *targs) == jax_analysis.activation_count(jax_fn, *jargs) \
        == 2 * 10 * 14 * 8 + 2 * 5


def test_parameter_counts_equal_jax_on_tiny_idol():
    jmodel = JaxIDOL(**TINY_IDOL, msda_impl="jnp")
    x, s = jnp.zeros((1, 64, 96, 3)), jnp.asarray([[64, 96]], jnp.int32)
    params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x, s, method=JaxIDOL.inference))["params"]
    with torch.device("meta"):
        port = IDOL(**TINY_IDOL)
    assert analysis.parameter_count(port) == jax_analysis.parameter_count(params)
    assert analysis.parameter_count_table(port) == jax_analysis.parameter_count_table(params)
    assert analysis.parameter_count_table(port, 3) == jax_analysis.parameter_count_table(params, 3)


def _tiny(cls):
    # one decoder layer and 8 queries keep the trace (~1.7k nodes) and the .pt2 round trip short
    model = cls(**{**TINY_IDOL, "backbone_depth": 18, "dec_layers": 1, "num_queries": 8}, dtype=torch.bfloat16)
    init_weights(model, 1)
    return model.eval()


@pytest.mark.parametrize("cls", [IDOL, SeqFormer], ids=["IDOL", "SeqFormer"])
def test_tiny_model_exports_loads_and_runs_bit_equal(cls, tmp_path):
    model = _tiny(cls)
    images, sizes = example_inputs(model, 2, 64, 96, "cpu")
    images = torch.randn(images.shape, generator=torch.Generator().manual_seed(2))
    sizes[..., 1] = 90
    fn = inference_fn(model)
    with plain_versions_refused():
        exported = export_program(fn, (images, sizes))
    want_ops = {"msda_fwd": 2, "stem_conv": 1, "encoder_epilogue": 1}
    if cls is SeqFormer:
        want_ops = {"msda_fwd": 1, "msda_fwd_loc": 1, "stem_conv": 1, "encoder_epilogue": 1}
    assert vnext_op_counts(exported) == want_ops
    assert all(p.requires_grad for p in model.parameters())     # restored after the trace
    path = str(tmp_path / "m.pt2")
    save_exported(exported, path)
    program = load_exported(path).module()
    with torch.no_grad():
        got, eager = program(images, sizes), fn(images, sizes)
    assert set(got) == set(eager)
    for k in eager:
        assert torch.equal(got[k], eager[k]), k


def test_plain_versions_refused_catches_a_bypassed_operator():
    value, off, ref, logits, _ = _op_args()["msda_fwd"]
    with plain_versions_refused(), pytest.raises(RuntimeError, match="ms_deform_attn_plain"):
        export_program(lambda *a: ms_deform_attn.ms_deform_attn_plain(a[0], LEVELS, *a[1:]),
                       (value, off, ref, logits))
    assert torch.equal(ms_deform_attn.ms_deform_attn(value, LEVELS, off, ref, logits),
                       ms_deform_attn.ms_deform_attn_plain(value, LEVELS, off, ref, logits))     # restored
