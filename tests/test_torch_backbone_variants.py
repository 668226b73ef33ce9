"""The ResNet variants, RegNet, the C4 head and the stem's odd-size repair in
the port against the JAX package, on the CPU.

- The stem: an odd side is padded with one zero row or column, which leaves
  the unpadded convolution: the port's bf16 stem at odd shapes within one
  bf16 ulp of JAX's XLA oracle (``stem_conv_reference``), as
  tests/test_torch_stem_conv.py holds the even ones, and its gradient against
  JAX's VJP of the stem's linearization point (``_stem_ref_f32``) at 1e-3
  relative L2 (the same f32 products summed in other orders; the kernel's
  gradient rounded to bf16 on both sides). A bf16 ResNet-18 runs the odd
  image [1, 50, 67, 3] as JAX's does, each output within 3e-2 relative L2:
  JAX's CPU stem rounds its convolution and then its affine to bf16, the
  port's once (the kernel's contract), and 17 more bf16 layers carry that on.
- ``deform_conv2d`` v1 / v2 at strides 1 and 2 and dilations 1 and 2 (v1 at
  stride 1 and dilation 2, v2 at stride 2 and dilation 1), and its
  gradients in x, the offsets, the weight and the modulation, at 1e-5 of each
  one's largest (f32 both sides, the taps' products summed in one product
  here, tap by tap there).
- ResNeXt (grouped 3x3) with DC5 (res5 at stride 1, dilation 2), and DCN v1
  / v2 ResNet-50s, each tree carried by ``from_jax``: in f32 every output
  within 1e-4 of its largest (50 layers of f32 convolutions summed in other
  orders); in bf16 within 3e-2 relative L2 (the stem's roundings above, and
  bf16 convolutions rounded by two libraries).
- ``build_resnet_backbone`` reads JAX's four keys and returns JAX's output
  keys (res2 always added); ``output_strides``.
- RegNet: ``generate_regnet_params`` exactly equal for X- and Y-400MF (and
  the slice's 4GF), and both 400MF trunks' forwards in f32 within 1e-4 of
  each output's largest.
- ``Res5ROIHeads`` with and without masks in f32: outputs within 1e-4 of
  their largest.
- ``from_jax`` on every new tree at the slice's widths (ResNeXt-101 32x8d,
  RegNetY-4GF, the 80-class C4 head with masks, the 10-class rotated heads;
  the DCN trees above are R-50's own widths already): every key and shape
  lands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vnext_tpu.config import get_cfg as jax_get_cfg
from vnext_tpu.models.backbones.regnet import RegNet as JaxRegNet
from vnext_tpu.models.backbones.regnet import generate_regnet_params as jax_regnet_params
from vnext_tpu.models.backbones.resnet import ResNet as JaxResNet
from vnext_tpu.models.backbones.resnet import build_resnet_backbone as jax_build_resnet
from vnext_tpu.models.roi_heads_extra import Res5ROIHeads as JaxRes5ROIHeads
from vnext_tpu.models.roi_heads_extra import RROIHeads as JaxRROIHeads
from vnext_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from vnext_tpu.ops.stem_conv import _stem_ref_f32, stem_conv_reference
from vnext_tpu_torch.checkpoint.from_jax import load_from_jax, params_from_jax
from vnext_tpu_torch.config import get_cfg
from vnext_tpu_torch.models import BACKBONE_REGISTRY, RegNet, Res5ROIHeads, RROIHeads, build_resnet_backbone
from vnext_tpu_torch.models.backbones.regnet import REGNET_CONFIGS, generate_regnet_params
from vnext_tpu_torch.models.backbones.resnet import ResNet
from vnext_tpu_torch.ops import deform_conv2d
from vnext_tpu_torch.ops import stem_conv as stem

from _torch_helpers import bf16_ulp, random_params, t

torch.set_num_threads(2)
ALL = ("res2", "res3", "res4", "res5")


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _nchw(a):
    return np.asarray(jnp.asarray(a, jnp.float32)).transpose(0, 3, 1, 2)


# ---------------------------------------------------------------- the stem's repair
@pytest.mark.parametrize("shape", [(1, 50, 67), (2, 31, 48), (1, 32, 49)], ids=["both", "h", "w"])
def test_stem_pads_odd_sizes(shape):
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape, 3).astype(np.float32)
    k = (rng.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    scale, bias = (rng.rand(64) + 0.5).astype(np.float32), (rng.randn(64) * 0.1).astype(np.float32)
    got = stem.stem_conv7x7s2_bn_relu(t(x), t(k), t(scale), t(bias))
    assert got.shape == (shape[0], (shape[1] + 1) // 2, (shape[2] + 1) // 2, 64)
    want = np.asarray(stem_conv_reference(jnp.asarray(x), jnp.asarray(k, jnp.bfloat16), jnp.asarray(scale),
                                          jnp.asarray(bias)), np.float32)
    g = got.float().numpy()
    assert np.all(np.abs(g - want) <= bf16_ulp(np.maximum(np.abs(g), np.abs(want))))
    # the padded convolution is the unpadded one
    unpadded = stem.stem_conv_ref_f32(t(x).to(torch.bfloat16).float(), t(k), t(scale), t(bias)).numpy()
    assert np.all(np.abs(g - unpadded) <= bf16_ulp(np.abs(unpadded)))


def test_stem_gradient_matches_jax_vjp():
    rng = np.random.RandomState(1)
    x = rng.randn(1, 25, 33, 3).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)          # bf16-exact, as the ResNet feeds it
    k = (rng.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    scale, bias = (rng.rand(64) + 0.5).astype(np.float32), (rng.randn(64) * 0.1).astype(np.float32)
    g = rng.randn(1, 13, 17, 64).astype(np.float32)
    _, vjp = jax.vjp(_stem_ref_f32, jnp.asarray(x), jnp.asarray(k, jnp.bfloat16), jnp.asarray(scale),
                     jnp.asarray(bias))
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    leaves = [t(a).requires_grad_() for a in (x, k, scale, bias)]
    stem.stem_conv7x7s2_bn_relu(*leaves).backward(t(g).to(torch.bfloat16))
    for name, leaf, w in zip(("x", "kernel", "scale", "bias"), leaves, want):
        assert leaf.grad.shape == leaf.shape
        assert _rel_l2(leaf.grad.numpy(), np.asarray(w, np.float32)) <= 1e-3, name


def test_bf16_resnet_runs_odd_sizes_like_jax():
    x = np.random.RandomState(2).randn(1, 50, 67, 3).astype(np.float32)
    module = JaxResNet(depth=18, out_features=ALL, dtype=jnp.bfloat16)
    tree = random_params(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 50, 67, 3))))
    want = jax.jit(lambda p, x: module.apply({"params": p}, x))(tree, jnp.asarray(x))
    port = ResNet(18, torch.bfloat16, out_features=ALL)
    load_from_jax(port, jax.tree.map(np.asarray, tree))
    with torch.no_grad():
        got = port(t(x))
    for name in ALL:
        assert got[name].shape == _nchw(want[name]).shape
        assert _rel_l2(got[name].float().numpy(), _nchw(want[name])) <= 3e-2, name


# ---------------------------------------------------------------- deformable convolution
@pytest.mark.parametrize("modulated,stride,dilation", [(False, 1, 2), (True, 2, 1)], ids=["v1-s1-d2", "v2-s2-d1"])
def test_deform_conv2d_matches_jax(modulated, stride, dilation):
    rng = np.random.RandomState(10 * stride + dilation + modulated)
    b, h, w, cin, cout = 2, 9, 11, 5, 6
    ho = (h + 2 * dilation - 2 * dilation - 1) // stride + 1
    wo = (w + 2 * dilation - 2 * dilation - 1) // stride + 1
    x = rng.randn(b, h, w, cin).astype(np.float32)
    off = (rng.randn(b, ho, wo, 18) * 1.5).astype(np.float32)           # some taps land outside the map
    weight = (rng.randn(3, 3, cin, cout) * 0.2).astype(np.float32)
    bias = (rng.randn(cout) * 0.1).astype(np.float32)
    mod = rng.rand(b, ho, wo, 9).astype(np.float32) if modulated else None
    g = rng.randn(b, ho, wo, cout).astype(np.float32)

    def f(x, off, weight, mod):
        return jax_deform_conv2d(x, off, weight, jnp.asarray(bias), stride, dilation, dilation, mod)

    args = [jnp.asarray(a) for a in (x, off, weight)] + ([jnp.asarray(mod)] if modulated else [])

    @jax.jit
    def forward_and_vjp(*a):
        out, vjp = jax.vjp(lambda *a: f(*a, *([None] if not modulated else [])), *a)
        return out, vjp(jnp.asarray(g))

    want, want_grads = forward_and_vjp(*args)
    leaves = [t(a).requires_grad_() for a in (x, off, weight)] + ([t(mod).requires_grad_()] if modulated else [])
    got = deform_conv2d(leaves[0], leaves[1], leaves[2], t(bias), stride=stride, padding=dilation,
                        dilation=dilation, modulation=leaves[3] if modulated else None)
    assert got.dtype == torch.float32 and got.shape == (b, ho, wo, cout)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5 * np.abs(want).max())
    got.backward(t(g))
    for name, leaf, w_ in zip(("x", "offsets", "weight", "modulation"), leaves, want_grads):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(leaf.grad.numpy(), w_, rtol=0, atol=1e-5 * np.abs(w_).max(), err_msg=name)


# ---------------------------------------------------------------- ResNet variants
VARIANTS = {
    "resnext_dc5": dict(groups=4, width_per_group=8, res5_dilation=2),
    "dcn_v1": dict(deform_on_per_stage=(False, False, False, True)),
    "dcn_v2": dict(deform_on_per_stage=(False, False, False, True), deform_modulated=True),
}


@pytest.mark.parametrize("variant,dtype", [("resnext_dc5", "f32"), ("resnext_dc5", "bf16"), ("dcn_v1", "f32"),
                                           ("dcn_v2", "bf16")])
def test_resnet_variants_match_jax(variant, dtype):
    kw = VARIANTS[variant]
    hw = (32, 48) if dtype == "f32" else (33, 47)
    x = np.random.RandomState(3).randn(1, *hw, 3).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    module = JaxResNet(depth=50, out_features=ALL, dtype=jdt, **kw)
    tree = random_params(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, *hw, 3))), seed=4)
    want = jax.jit(lambda p, x: module.apply({"params": p}, x))(tree, jnp.asarray(x))
    port = ResNet(50, tdt, out_features=ALL, **kw)
    load_from_jax(port, jax.tree.map(np.asarray, tree))
    assert port.output_strides == module.output_strides
    with torch.no_grad():
        got = port(t(x))
    for name in ALL:
        g, w = got[name].float().numpy(), _nchw(want[name])
        assert g.shape == w.shape, name
        if dtype == "f32":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)
        else:
            assert _rel_l2(g, w) <= 3e-2, name


def test_build_resnet_backbone_reads_jax_keys():
    cfgs = [get_cfg(), jax_get_cfg()]
    for c in cfgs:
        c.merge_from_list(["MODEL.RESNETS.DEPTH", "101", "MODEL.RESNETS.OUT_FEATURES", "['res4', 'res5']",
                           "MODEL.RESNETS.RES5_DILATION", "2", "MODEL.RESNETS.STRIDE_IN_1X1", "True",
                           "MODEL.RESNETS.NUM_GROUPS", "32", "MODEL.RESNETS.WIDTH_PER_GROUP", "8"])
    port, jx = BACKBONE_REGISTRY.get("build_resnet_backbone")(cfgs[0]), jax_build_resnet(cfgs[1])
    assert build_resnet_backbone is BACKBONE_REGISTRY.get("build_resnet_backbone")
    assert port.depth == jx.depth == 101 and port.res5_dilation == jx.res5_dilation == 2
    assert port.output_strides == jx.output_strides == {"res2": 4, "res3": 8, "res4": 16, "res5": 16}
    # NUM_GROUPS / WIDTH_PER_GROUP are not read by either builder: a plain ResNet-101's widths
    assert port.layer1_0.conv2.weight.shape == (64, 64, 3, 3) and port.layer1_0.conv1.stride == 1
    assert port.layer2_0.conv1.stride == 2                             # STRIDE_IN_1X1
    out = jax.eval_shape(lambda: jx.init_with_output(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))[0]
    assert set(port.out_features) == set(out) == {"res2", "res4", "res5"}


# ---------------------------------------------------------------- RegNet
@pytest.mark.parametrize("variant", ["RegNetX-400MF", "RegNetY-400MF", "RegNetX-4GF", "RegNetY-4GF"])
def test_generate_regnet_params_exact(variant):
    w_a, w_0, w_m, depth, gw, _ = REGNET_CONFIGS[variant]
    assert generate_regnet_params(w_a, w_0, w_m, depth, gw) == jax_regnet_params(w_a, w_0, w_m, depth, gw)


@pytest.mark.parametrize("variant", ["RegNetX-400MF", "RegNetY-400MF"])
def test_regnet_matches_jax(variant):
    x = np.random.RandomState(5).randn(1, 32, 48, 3).astype(np.float32)
    module = JaxRegNet(variant=variant)
    tree = random_params(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 48, 3))), seed=6)
    want = jax.jit(lambda p, x: module.apply({"params": p}, x))(tree, jnp.asarray(x))
    port = RegNet(variant)
    load_from_jax(port, jax.tree.map(np.asarray, tree))
    assert port.output_channels == module.output_channels and port.output_strides == module.output_strides
    with torch.no_grad():
        got = port(t(x))
    for name in ALL:
        w = _nchw(want[name])
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=name)


# ---------------------------------------------------------------- the C4 head
@pytest.mark.parametrize("mask_on", [False, True], ids=["boxes", "masks"])
def test_res5_roi_heads_match_jax(mask_on):
    rng = np.random.RandomState(7)
    res4 = rng.randn(2, 6, 8, 1024).astype(np.float32)
    xy = rng.uniform(0, 80, (2, 3, 2))
    rois = np.concatenate([xy, xy + rng.uniform(12, 40, (2, 3, 2))], -1).astype(np.float32)
    module = JaxRes5ROIHeads(num_classes=3, mask_on=mask_on)
    tree = random_params(lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(res4), jnp.asarray(rois)), seed=8)
    want = jax.jit(lambda p: module.apply({"params": p}, jnp.asarray(res4), jnp.asarray(rois)))(tree)
    port = Res5ROIHeads(num_classes=3, mask_on=mask_on)
    load_from_jax(port, jax.tree.map(np.asarray, tree))
    with torch.no_grad():
        got = port(t(res4).permute(0, 3, 1, 2), t(rois))
    assert set(got) == set(want) == {"cls_logits", "box_deltas"} | ({"mask_logits"} if mask_on else set())
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)


# ---------------------------------------------------------------- from_jax at the slice's widths
def _full_width_trees():
    x = jnp.zeros((1, 64, 64, 3))
    res4, rois4, rois5 = jnp.zeros((1, 4, 4, 1024)), jnp.zeros((1, 2, 4)), jnp.zeros((1, 2, 5))
    yield ("ResNeXt-101 32x8d", JaxResNet(depth=101, groups=32, width_per_group=8, out_features=ALL), (x,),
           lambda: ResNet(101, out_features=ALL, groups=32, width_per_group=8))
    yield "RegNetY-4GF", JaxRegNet(variant="RegNetY-4GF"), (x,), lambda: RegNet("RegNetY-4GF")
    yield ("C4 head, 80 classes, masks", JaxRes5ROIHeads(num_classes=80, mask_on=True), (res4, rois4),
           lambda: Res5ROIHeads(80, mask_on=True))
    yield "rotated heads, 10 classes", JaxRROIHeads(), (res4, rois5, 1 / 16), lambda: RROIHeads()


def test_from_jax_carries_every_new_tree_at_full_width():
    for what, module, args, build in _full_width_trees():
        shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"]
        tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        with torch.device("meta"):
            port = build()
        own = {k: tuple(v.shape) for k, v in port.state_dict().items()}
        bridged = {k: tuple(v.shape) for k, v in params_from_jax(tree).items()}
        assert own == bridged, what
        del tree, bridged
