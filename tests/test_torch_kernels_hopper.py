"""K2 (the stem as an implicit GEMM on the tensor cores), K1 (the fused MSDA
forward, one warp per query with 16-byte corner loads), K3 (the encoder
epilogue on ``wgmma`` with bulk-copied weights), K5 (the MSDA backward on
K1's mapping, with vector reductions), K4 and K4b (the MSDA forward from
given locations, standard and channel-major, on K1's loop with K5's
prologue) and K9 (the dynamic-offset accumulate, one thread per output
element) against their plain versions on the card, at the edges of their
tilings and sampling rules, and K1 and K3 at MinVIS-R50's pixel-decoder shapes
(3 levels, coarsest first). Also one Swin-L stage-3 block (no hand-written
kernel: the window attention is library products) on the card in bf16 against
the CPU in f32.

Every test here needs a CUDA device (``cuda`` marker; skipped without one):
``python -m pytest -m cuda tests/test_torch_kernels_hopper.py``. This file
imports nothing of the JAX package, so it runs where flax is not installed.
The stem's K packing and the epilogue's weight packing, which the CPU reaches,
are held in ``tests/test_torch_stem_conv.py`` and
``tests/test_torch_encoder_epilogue.py``.
"""

import numpy as np
import pytest
import torch

from vnext_tpu_torch.ops import encoder_epilogue, ms_deform_attn, stem_conv
from vnext_tpu_torch.tools import exp_dynstore

from _torch_helpers import cuda_device  # noqa: F401 (fixture)

BF16_ULP = 2.0 ** -7


def _max_err(got, want):
    return float((got.float() - want.float()).abs().max()), float(want.float().abs().max())


def _stem_args(dev, shape, seed=0):
    rng = np.random.RandomState(seed)
    arrays = (rng.randn(*shape), rng.randn(7, 7, 3, 64) * 0.1, rng.rand(64) + 0.5, rng.randn(64) * 0.1)
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 38, 70, 3), (3, 34, 1030, 3), (4, 512, 640, 3), (2, 2, 2, 3)],
                         ids=["partial-tiles", "wide-partial", "train", "one-pixel"])
def test_stem_kernel_at_tile_edges(cuda_device, shape):
    """Partial 16 x 32 output tiles on both axes (HO = 19 / 17, WO = 35 / 515),
    the train shape, and a single output pixel whose halo is all padding but one
    input pixel."""
    args = _stem_args(cuda_device, shape)
    before = stem_conv.KERNEL.launches
    got = stem_conv.stem_conv7x7s2_bn_relu(*args)
    want = stem_conv.stem_conv_plain(*args)
    assert stem_conv.KERNEL.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err, scale = _max_err(got, want)
    # exact bf16 x bf16 products summed in f32 in two orders, one bf16 rounding each
    assert err <= BF16_ULP * scale, err


@pytest.mark.cuda
def test_stem_kernel_refuses_what_it_does_not_take(cuda_device):
    x, k, scale, bias = _stem_args(cuda_device, (1, 8, 8, 3))
    before = stem_conv.KERNEL.launches
    flat = torch.zeros(x.numel() + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        stem_conv.stem_conv7x7s2_bn_relu(flat[1:].view_as(x), k, scale, bias)
    with pytest.raises(TypeError, match="float32"):
        stem_conv.stem_conv7x7s2_bn_relu(x.to(torch.bfloat16), k, scale, bias)
    with pytest.raises(ValueError, match="even"):
        torch.ops.vnext.stem_conv(x[:, :7].contiguous(), k, scale, bias)
    assert stem_conv.KERNEL.launches == before
    # the wrapper pads an odd side with zeros and launches the kernel on the padded input
    got = stem_conv.stem_conv7x7s2_bn_relu(x[:, :7], k, scale, bias)
    want = stem_conv.stem_conv_plain(x[:, :7], k, scale, bias)
    assert got.shape == want.shape == (1, 4, 4, 64) and stem_conv.KERNEL.launches == before + 1
    assert float((got.float() - want.float()).abs().max()) <= 2.0 ** -7 * float(want.float().abs().max())


def _edge_samples(levels, q, m, p, box, rng):
    """Offsets [1, q, m, L, P, 2] and references [1, q, L, 2|4] whose samples
    include x = -1 and x = w - 1 exactly, pixel centres and far outside, for a
    point form whose references sit on pixel centres."""
    l = len(levels)
    wh = np.asarray([[w, h] for h, w in levels], np.float64)
    if box:
        ref = np.concatenate([rng.rand(1, q, l, 2), rng.rand(1, q, l, 2) * 0.5 + 0.05], -1)
        off = rng.randn(1, q, m, l, p, 2) * 3.0
    else:
        # ref on the centre of pixel (i, j): ref * w - 0.5 = i exactly when w is a power of two
        cells = rng.randint(0, 1 << 20, (1, q, l, 2)) % wh.astype(np.int64)
        ref = (cells + 0.5) / wh
        off = rng.randn(1, q, m, l, p, 2) * 3.0
        off[..., 0, :] = np.round(off[..., 0, :])                         # pixel centres
        off[:, :, :, :, 1 % p, 0] = -1.0 - cells[:, :, None, :, 0]        # x = -1 exactly
        off[:, :, :, :, 2 % p, 0] = (wh[:, 0] - 1.0) - cells[:, :, None, :, 0]   # x = w - 1
    far = rng.rand(1, q, m, l, p) < 0.05
    off[far] = 300.0
    return off, ref


@pytest.mark.cuda
@pytest.mark.parametrize("box", [False, True], ids=["point", "box"])
@pytest.mark.parametrize("levels,p,m,q", [
    (((16, 32), (8, 16), (4, 8), (1, 1)), 4, 8, 301),     # 4 levels, one 1 x 1; L*P = 16
    (((16, 16),), 4, 8, 301),                               # 1 level: L*P = 4
    (((8, 16), (4, 8), (2, 4), (1, 1)), 2, 4, 37),         # L*P = 8, half a head group
    (((8, 16), (4, 8)), 4, 12, 64),                         # two head groups, the second half full
], ids=["L4-1x1", "L1", "L4P2-M4", "L2-M12"])
def test_msda_kernel_at_sampling_edges(cuda_device, box, levels, p, m, q):
    rng = np.random.RandomState(q + 7 * m + box)
    s, l, d = sum(h * w for h, w in levels), len(levels), 32
    off, ref = _edge_samples(levels, q, m, p, box, rng)
    bf16 = torch.bfloat16
    args = (torch.tensor(rng.randn(1, s, m, d), dtype=bf16, device=cuda_device), levels,
            torch.tensor(off, dtype=bf16, device=cuda_device),
            torch.tensor(ref, dtype=torch.float32, device=cuda_device),
            torch.tensor(rng.randn(1, q, m, l * p) * 2.0, dtype=bf16, device=cuda_device))
    before = ms_deform_attn.KERNEL.launches
    got = ms_deform_attn.ms_deform_attn(*args)
    want = ms_deform_attn.ms_deform_attn_plain(*args)
    assert ms_deform_attn.KERNEL.launches == before + 1
    err, scale = _max_err(got, want)
    # both sum the same bf16 inputs in f32 and round once to bf16, in other orders
    assert err <= BF16_ULP * scale, err


@pytest.mark.cuda
def test_msda_kernel_at_serving_query_count(cuda_device):
    """Q = S = 8617 (IDOL-R50's encoder at 480x864), not a multiple of a
    block's 8 queries."""
    levels = ((60, 108), (30, 54), (15, 27), (8, 14))
    rng = np.random.RandomState(8617)
    s, m, l, p, d = 8617, 8, 4, 4, 32
    ref = rng.rand(1, s, l, 2)
    bf16 = torch.bfloat16
    args = (torch.tensor(rng.randn(1, s, m, d), dtype=bf16, device=cuda_device), levels,
            torch.tensor(rng.randn(1, s, m, l, p, 2) * 3.0, dtype=bf16, device=cuda_device),
            torch.tensor(ref, dtype=torch.float32, device=cuda_device),
            torch.tensor(rng.randn(1, s, m, l * p) * 2.0, dtype=bf16, device=cuda_device))
    got = ms_deform_attn.ms_deform_attn(*args)
    want = ms_deform_attn.ms_deform_attn_plain(*args)
    err, scale = _max_err(got, want)
    assert err <= BF16_ULP * scale, err


@pytest.mark.cuda
def test_msda_kernel_skips_nan_samples_whole(cuda_device):
    """A NaN sample is skipped whole, as one far outside every level is: the
    plain version cannot take NaN (its gather index is undefined), so the
    kernel's output with NaN offsets must equal, bit for bit, its output with
    those samples at +300 pixels, which the plain version confirms."""
    levels = ((16, 32), (8, 16), (4, 8), (1, 1))
    rng = np.random.RandomState(5)
    q, m, p = 301, 8, 4
    off, ref = _edge_samples(levels, q, m, p, False, rng)
    nan = rng.rand(*off.shape[:-1]) < 0.05
    far = off.copy()
    far[nan] = 300.0
    off[nan, rng.randint(0, 2, int(nan.sum()))] = np.nan
    bf16 = torch.bfloat16
    s = sum(h * w for h, w in levels)
    value = torch.tensor(rng.randn(1, s, m, 32), dtype=bf16, device=cuda_device)
    ref_t = torch.tensor(ref, dtype=torch.float32, device=cuda_device)
    logits = torch.tensor(rng.randn(1, q, m, len(levels) * p), dtype=bf16, device=cuda_device)
    got_nan = ms_deform_attn.ms_deform_attn(value, levels, torch.tensor(off, dtype=bf16, device=cuda_device),
                                            ref_t, logits)
    far_t = torch.tensor(far, dtype=bf16, device=cuda_device)
    got_far = ms_deform_attn.ms_deform_attn(value, levels, far_t, ref_t, logits)
    assert torch.isfinite(got_nan.float()).all()
    assert torch.equal(got_nan, got_far)
    want = ms_deform_attn.ms_deform_attn_plain(value, levels, far_t, ref_t, logits)
    err, scale = _max_err(got_far, want)
    assert err <= BF16_ULP * scale, err


@pytest.mark.cuda
def test_msda_kernel_refuses_misaligned_views(cuda_device):
    levels = ((4, 8), (2, 4))
    b, q, m, l, p, d = 1, 5, 8, 2, 4, 32
    s = 40
    bf16 = torch.bfloat16
    flat = torch.zeros(b * s * m * d + 8, dtype=bf16, device=cuda_device)
    value = flat[1:1 + b * s * m * d].view(b, s, m, d)                 # 2 bytes off
    off = torch.zeros(b, q, m, l, p, 2, dtype=bf16, device=cuda_device)
    ref = torch.rand(b, q, l, 2, device=cuda_device)
    logits = torch.zeros(b, q, m, l * p, dtype=bf16, device=cuda_device)
    before = ms_deform_attn.KERNEL.launches
    with pytest.raises(ValueError, match="16-byte"):
        ms_deform_attn.ms_deform_attn(value, levels, off, ref, logits)
    flat_off = torch.zeros(off.numel() + 8, dtype=bf16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        ms_deform_attn.ms_deform_attn(flat[:b * s * m * d].view(b, s, m, d), levels,
                                      flat_off[4:4 + off.numel()].view_as(off), ref, logits)
    assert ms_deform_attn.KERNEL.launches == before


def _epilogue_args(dev, n, f, seed=0):
    rng = np.random.RandomState(seed + n + f)
    c = 256
    a, src = rng.randn(1, n, c) * 0.5, rng.randn(1, n, c)
    params = (rng.rand(c) + 0.5, rng.randn(c) * 0.1, rng.randn(f, c) / 16, rng.randn(f) * 0.1,
              rng.randn(c, f) / np.sqrt(f), rng.randn(c) * 0.1, rng.rand(c) + 0.5, rng.randn(c) * 0.1)
    a, src = (torch.tensor(x, dtype=torch.bfloat16, device=dev) for x in (a, src))
    return a, src, [torch.tensor(x, dtype=torch.float32, device=dev) for x in params]


@pytest.mark.cuda
@pytest.mark.parametrize("f", [64, 1024, 2048])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 2 * 8617])
def test_epilogue_kernel_at_tile_edges(cuda_device, n, f):
    """A ragged last tile of 128 tokens (N = 1, 127, 129), exactly one tile,
    IDOL-R50's encoder at two frames (more tiles than SMs, so blocks walk
    several), and one, 16 and 32 FFN chunks through the 4-slot weight ring."""
    a, src, params = _epilogue_args(cuda_device, n, f)
    before = encoder_epilogue.KERNEL.launches
    got = encoder_epilogue.encoder_epilogue(a, src, *params)
    want = encoder_epilogue.encoder_epilogue_plain(a, src, *params)
    assert encoder_epilogue.KERNEL.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err, scale = _max_err(got, want)
    # the final rounding plus the plain version's bf16 roundings of both products
    assert err <= 2 * BF16_ULP * scale, err


@pytest.mark.cuda
def test_epilogue_kernel_refuses_what_it_does_not_take(cuda_device):
    a, src, params = _epilogue_args(cuda_device, 40, 128)
    before = encoder_epilogue.KERNEL.launches
    flat = torch.zeros(src.numel() + 8, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        encoder_epilogue.encoder_epilogue(a, flat[1:1 + src.numel()].view_as(src), *params)
    wide = torch.zeros(1, 40, 512, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(TypeError, match="contiguous"):
        encoder_epilogue.encoder_epilogue(a, wide[..., ::2], *params)
    with pytest.raises(ValueError, match="d_model 256"):
        encoder_epilogue.encoder_epilogue(a[..., :128].contiguous(), src[..., :128].contiguous(),
                                          *params)
    w1, b1, w2 = params[2][:96], params[3][:96], params[4][:, :96]
    with pytest.raises(ValueError, match="F % 64"):
        encoder_epilogue.encoder_epilogue(a, src, params[0], params[1], w1, b1, w2.contiguous(),
                                          *params[5:])
    assert encoder_epilogue.KERNEL.launches == before


def _k5_locations(levels, b, q, m, p, rng):
    """Normalized locations [b, q, m, L, P, 2] on power-of-two levels (so that
    x = loc * w - 0.5 is exact): a quarter on pixel centres, point 1 at x = -1
    and point 2 at x = w - 1 exactly (and y likewise for half of the queries),
    5% far outside every level, the rest uniform over the level and a little
    beyond."""
    wh = np.asarray([[w, h] for h, w in levels], np.float64)[None, None, None, :, None, :]
    loc = rng.rand(b, q, m, len(levels), p, 2) * 1.2 - 0.1
    cells = rng.randint(0, 1 << 20, loc.shape) % wh.astype(np.int64)
    centre = rng.rand(*loc.shape[:-1]) < 0.25
    loc[centre] = ((cells + 0.5) / wh)[centre]
    axes = [0] if p < 2 else [0, 1]
    for axis in axes:
        sel = slice(None) if axis == 0 else slice(0, q // 2)
        loc[:, sel, :, :, 1 % p, axis] = (-0.5 / wh[..., axis])[:, 0, :, :, 0]
        loc[:, sel, :, :, 2 % p, axis] = ((wh[..., axis] - 0.5) / wh[..., axis])[:, 0, :, :, 0]
    far = rng.rand(*loc.shape[:-1]) < 0.05
    loc[far] = rng.choice([-4.0, 5.0], size=(int(far.sum()), 2))
    return loc


@pytest.mark.cuda
@pytest.mark.parametrize("levels,q", [
    (((16, 32), (8, 16), (4, 8), (1, 1)), 301),     # 4 levels, one 1 x 1
    (((16, 32), (8, 16), (4, 8), (1, 1)), 6800),    # the train encoder's query count
    (((16, 16),), 301),                               # 1 level: L*P = 4
], ids=["L4-Q301", "L4-Q6800", "L1-Q301"])
def test_msda_backward_kernel_at_sampling_edges(cuda_device, levels, q):
    """K5 against the plain version's autograd, element by element: dvalue and
    dattn within one bf16 ulp of |want| plus 2^-16 of the element's sum of
    |terms| (the same f32 products summed in other orders, dvalue's reductions
    in one that changes from run to run, each rounded once to bf16); dloc (f32)
    within 1e-5 of its largest element. Q is not a multiple of a block's 8
    queries."""
    rng = np.random.RandomState(q + len(levels))
    b, m, d, p = 2, 8, 32, 4
    s = sum(h * w for h, w in levels)
    bf16 = torch.bfloat16
    value = torch.tensor(rng.randn(b, s, m, d), dtype=bf16, device=cuda_device)
    loc = torch.tensor(_k5_locations(levels, b, q, m, p, rng), dtype=torch.float32, device=cuda_device)
    attn = torch.softmax(torch.tensor(rng.randn(b, q, m, len(levels) * p), device=cuda_device).float(), -1)
    attn = attn.to(bf16).view(b, q, m, len(levels), p).contiguous()
    grad = torch.tensor(rng.randn(b, q, m * d), dtype=bf16, device=cuda_device)
    before = ms_deform_attn.KERNEL_V9_BWD.launches
    got = ms_deform_attn.ms_deform_attn_v9_backward(value, levels, loc, attn, grad)
    assert ms_deform_attn.KERNEL_V9_BWD.launches == before + 1
    want = ms_deform_attn.ms_deform_attn_grad_plain(value, levels, loc, attn, grad)
    abs_sums = ms_deform_attn.ms_deform_attn_grad_plain(value.abs(), levels, loc, attn, grad.abs())
    for i in (0, 2):
        g, w, limit = got[i].float(), want[i].float(), abs_sums[i].float()
        assert got[i].dtype == bf16
        excess = (g - w).abs() - (BF16_ULP * w.abs() + 2.0 ** -16 * limit)
        assert float(excess.max()) <= 0.0, (i, float(excess.max()))
    err, scale = _max_err(got[1], want[1])
    assert got[1].dtype == torch.float32 and err <= 1e-5 * scale, err


@pytest.mark.cuda
def test_msda_backward_kernel_refuses_misaligned_views(cuda_device):
    levels = ((4, 8), (2, 4))
    b, q, m, l, p, d = 1, 5, 8, 2, 4, 32
    s = 40
    bf16 = torch.bfloat16
    flat = torch.zeros(b * s * m * d + 8, dtype=bf16, device=cuda_device)
    value = flat[1:1 + b * s * m * d].view(b, s, m, d)                 # 2 bytes off
    loc = torch.rand(b, q, m, l, p, 2, device=cuda_device)
    attn = torch.full((b, q, m, l, p), 0.125, dtype=bf16, device=cuda_device)
    grad = torch.zeros(b, q, m * d, dtype=bf16, device=cuda_device)
    before = ms_deform_attn.KERNEL_V9_BWD.launches
    with pytest.raises(ValueError, match="16-byte"):
        ms_deform_attn.ms_deform_attn_v9_backward(value, levels, loc, attn, grad)
    flat_g = torch.zeros(grad.numel() + 8, dtype=bf16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):
        ms_deform_attn.ms_deform_attn_v9_backward(flat[:b * s * m * d].view(b, s, m, d), levels, loc, attn,
                                                  flat_g[4:4 + grad.numel()].view_as(grad))
    assert ms_deform_attn.KERNEL_V9_BWD.launches == before


def _k4_inputs(dev, levels, b, q, m, p, seed, nan=False):
    """value [b, S, m, 32], locations (as ``_k5_locations``: x = -1 and w - 1
    exactly, pixel centres, far outside) and softmaxed weights; with ``nan``,
    also the locations with 5% of the samples NaN in one coordinate and the
    same samples far outside in their place."""
    rng = np.random.RandomState(seed)
    s, l = sum(h * w for h, w in levels), len(levels)
    bf16 = torch.bfloat16
    value = torch.tensor(rng.randn(b, s, m, 32), dtype=bf16, device=dev)
    loc = _k5_locations(levels, b, q, m, p, rng)
    attn = torch.softmax(torch.tensor(rng.randn(b, q, m, l * p) * 2.0, device=dev).float(), -1)
    attn = attn.to(bf16).view(b, q, m, l, p).contiguous()
    if not nan:
        return value, torch.tensor(loc, dtype=torch.float32, device=dev), attn
    pick = rng.rand(*loc.shape[:-1]) < 0.05
    far = loc.copy()
    far[pick] = 5.0
    loc[pick, rng.randint(0, 2, int(pick.sum()))] = np.nan
    return value, [torch.tensor(x, dtype=torch.float32, device=dev) for x in (loc, far)], attn


def _k4_entry(entry, value, levels, loc, attn):
    """K4 (the standard entry, impl pallas_v9) or K4b (the channel-major entry
    on the same function's inputs, its output transposed back to [B, Q, M*D]),
    with the launch counter it must move."""
    if entry == "standard":
        before = ms_deform_attn.KERNEL_V9_FWD.launches
        with torch.no_grad():
            out = ms_deform_attn.ms_deform_attn_standard(value, levels, loc, attn, "pallas_v9")
        return out, ms_deform_attn.KERNEL_V9_FWD.launches - before
    b, s, m, d = value.shape
    value_t = value.view(b, s, m * d).transpose(1, 2).contiguous()
    before = ms_deform_attn.KERNEL_CM.launches
    with torch.no_grad():
        out = ms_deform_attn.ms_deform_attn_cm(value_t, levels, loc.permute(0, 2, 3, 4, 5, 1).contiguous(),
                                               attn.permute(0, 2, 3, 4, 1).contiguous())
    return out.transpose(1, 2), ms_deform_attn.KERNEL_CM.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["standard", "channel_major"])
@pytest.mark.parametrize("levels,p,m,q", [
    (((16, 32), (8, 16), (4, 8), (1, 1)), 4, 8, 301),     # 4 levels, one 1 x 1; L*P = 16
    (((16, 32), (8, 16), (4, 8), (1, 1)), 4, 8, 6800),    # the train encoder's query count
    (((16, 16),), 4, 8, 301),                               # 1 level: L*P = 4, the generic prologue
    (((8, 16), (4, 8), (2, 4), (1, 1)), 2, 4, 37),         # L*P = 8, half a head group
    (((8, 16), (4, 8)), 4, 16, 64),                         # two full head groups
    (((8, 16), (4, 8)), 4, 12, 65),                         # two head groups, the second half full
], ids=["L4-1x1-Q301", "L4-Q6800", "L1-Q301", "L4P2-M4-Q37", "L2-M16-Q64", "L2-M12-Q65"])
def test_msda_loc_kernels_at_sampling_edges(cuda_device, entry, levels, p, m, q):
    """K4 and K4b against the plain core, within one bf16 ulp at the largest
    output (both sum the same bf16 inputs in f32 and round once to bf16, in
    other orders). Q is not a multiple of K4's 8 queries per block nor of K4b's
    32-query tile but at Q = 64, so K4b's last tile is ragged; x = -1 and
    x = w - 1 exactly, pixel centres, far outside, a 1 x 1 level."""
    value, loc, attn = _k4_inputs(cuda_device, levels, 2, q, m, p, seed=q + m + p)
    got, launches = _k4_entry(entry, value, levels, loc, attn)
    want = ms_deform_attn.ms_deform_attn_core_plain(value, levels, loc, attn)
    assert launches == 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err, scale = _max_err(got, want)
    assert err <= BF16_ULP * scale, err


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["standard", "channel_major"])
def test_msda_loc_kernels_skip_nan_samples_whole(cuda_device, entry):
    """A NaN sample adds exactly nothing, as one far outside every level does:
    the plain version cannot take NaN (its gather index is undefined), so the
    kernel's output with NaN locations must equal, bit for bit, its output with
    those samples at 5.0 (far outside), which the plain version confirms."""
    levels = ((16, 32), (8, 16), (4, 8), (1, 1))
    value, (loc_nan, loc_far), attn = _k4_inputs(cuda_device, levels, 2, 301, 8, 4, seed=11, nan=True)
    got_nan, _ = _k4_entry(entry, value, levels, loc_nan, attn)
    got_far, _ = _k4_entry(entry, value, levels, loc_far, attn)
    assert torch.isfinite(got_nan.float()).all()
    assert torch.equal(got_nan, got_far)
    want = ms_deform_attn.ms_deform_attn_core_plain(value, levels, loc_far, attn)
    err, scale = _max_err(got_far, want)
    assert err <= BF16_ULP * scale, err


@pytest.mark.cuda
def test_msda_loc_kernels_refuse_misaligned_views(cuda_device):
    """K4 reads the value, the locations and the weights and writes its output
    in 16- and 8-byte vectors: a view of any input off a 16-byte boundary
    raises before a launch. K4b reads only the value so (its locations and
    weights one query per lane, in runs along Q): a token-major value view off
    the boundary raises; channel-major locations and weights at any offset are
    taken, and agree with the plain version."""
    levels = ((4, 8), (2, 4))
    b, q, m, l, p, d, s = 1, 5, 8, 2, 4, 32, 40
    bf16 = torch.bfloat16
    value, loc, attn = _k4_inputs(cuda_device, levels, b, q, m, p, seed=3)
    flat_v = torch.zeros(value.numel() + 8, dtype=bf16, device=cuda_device)
    flat_l = torch.zeros(loc.numel() + 4, device=cuda_device)
    flat_a = torch.zeros(attn.numel() + 8, dtype=bf16, device=cuda_device)
    value_off = flat_v[1:1 + value.numel()].view_as(value).copy_(value)         # 2 bytes off
    loc_off = flat_l[1:1 + loc.numel()].view_as(loc).copy_(loc)                # 4 bytes off
    attn_off = flat_a[2:2 + attn.numel()].view_as(attn).copy_(attn)            # 4 bytes off
    before = ms_deform_attn.KERNEL_V9_FWD.launches
    for args in ((value_off, loc, attn), (value, loc_off, attn), (value, loc, attn_off)):
        with pytest.raises(ValueError, match="16-byte"):
            ms_deform_attn.ms_deform_attn_standard(args[0], levels, args[1], args[2], "pallas_v9")
    assert ms_deform_attn.KERNEL_V9_FWD.launches == before

    before = ms_deform_attn.KERNEL_CM.launches
    loc_cm = loc.permute(0, 2, 3, 4, 5, 1).contiguous()
    attn_cm = attn.permute(0, 2, 3, 4, 1).contiguous()
    # a channel-major view of the misaligned token-major value: the wrapper's
    # transpose to token-major is then no copy
    with pytest.raises(ValueError, match="16-byte"):
        ms_deform_attn.ms_deform_attn_cm(value_off.view(b, s, m * d).transpose(1, 2), levels, loc_cm, attn_cm)
    assert ms_deform_attn.KERNEL_CM.launches == before
    loc_cm_off = flat_l[1:1 + loc.numel()].view_as(loc_cm).copy_(loc_cm)
    attn_cm_off = flat_a[2:2 + attn.numel()].view_as(attn_cm).copy_(attn_cm)
    value_t = value.view(b, s, m * d).transpose(1, 2).contiguous()
    got = ms_deform_attn.ms_deform_attn_cm(value_t, levels, loc_cm_off, attn_cm_off)
    assert ms_deform_attn.KERNEL_CM.launches == before + 1
    want = ms_deform_attn.ms_deform_attn_cm_plain(value_t, levels, loc_cm, attn_cm)
    err, scale = _max_err(got, want)
    assert err <= BF16_ULP * scale, err


# ---------------------------------------------------------------- MinVIS-R50's shapes
# the pixel decoder's levels at 480x864, coarsest first (strides 32, 16, 8)
MINVIS_LEVELS = ((15, 27), (30, 54), (60, 108))


@pytest.mark.cuda
def test_msda_kernel_at_minvis_shape(cuda_device):
    """K1 as MinVIS-R50's pixel decoder runs it on a window of 3 frames: Q = S =
    8505 grid references over 3 levels, coarsest first; L * P = 12 takes the
    kernel's generic prologue, not the L * P = 16 one."""
    rng = np.random.RandomState(8505)
    b, m, p, d = 3, 8, 4, 32
    s, l = sum(h * w for h, w in MINVIS_LEVELS), len(MINVIS_LEVELS)
    grid = np.concatenate([np.stack(np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h), -1)
                           .reshape(-1, 2) for h, w in MINVIS_LEVELS])
    ref = np.broadcast_to(grid[None, :, None, :], (b, s, l, 2))
    bf16 = torch.bfloat16
    args = (torch.tensor(rng.randn(b, s, m, d), dtype=bf16, device=cuda_device), MINVIS_LEVELS,
            torch.tensor(rng.randn(b, s, m, l, p, 2) * 3.0, dtype=bf16, device=cuda_device),
            torch.tensor(ref, dtype=torch.float32, device=cuda_device),
            torch.tensor(rng.randn(b, s, m, l * p) * 2.0, dtype=bf16, device=cuda_device))
    before = ms_deform_attn.KERNEL.launches
    got = ms_deform_attn.ms_deform_attn(*args)
    want = ms_deform_attn.ms_deform_attn_plain(*args)
    assert ms_deform_attn.KERNEL.launches == before + 1
    assert s == 8505 and got.shape == (b, s, m * d)
    err, scale = _max_err(got, want)
    assert err <= BF16_ULP * scale, err


@pytest.mark.cuda
@pytest.mark.parametrize("box", [False, True], ids=["point", "box"])
def test_msda_kernel_at_sampling_edges_coarsest_first(cuda_device, box):
    """3 levels, the smallest first (as Mask2Former orders them), L * P = 12:
    samples at x = -1 and x = w - 1 exactly, on pixel centres and far outside."""
    levels = ((2, 4), (4, 8), (8, 16))
    rng = np.random.RandomState(12 + box)
    s, l, p, m, q, d = sum(h * w for h, w in levels), 3, 4, 8, 301, 32
    off, ref = _edge_samples(levels, q, m, p, box, rng)
    bf16 = torch.bfloat16
    args = (torch.tensor(rng.randn(1, s, m, d), dtype=bf16, device=cuda_device), levels,
            torch.tensor(off, dtype=bf16, device=cuda_device),
            torch.tensor(ref, dtype=torch.float32, device=cuda_device),
            torch.tensor(rng.randn(1, q, m, l * p) * 2.0, dtype=bf16, device=cuda_device))
    before = ms_deform_attn.KERNEL.launches
    got = ms_deform_attn.ms_deform_attn(*args)
    want = ms_deform_attn.ms_deform_attn_plain(*args)
    assert ms_deform_attn.KERNEL.launches == before + 1
    err, scale = _max_err(got, want)
    assert err <= BF16_ULP * scale, err


# MinVIS-R50's train step: 512x768 frames, the pixel decoder's levels coarsest first
MINVIS_TRAIN_LEVELS = ((16, 24), (32, 48), (64, 96))
# SeqFormer-R50's train step: 512x640 frames at strides 8 to 64
SEQFORMER_TRAIN_LEVELS = ((64, 80), (32, 40), (16, 20), (8, 10))


# (levels, frames, queries, box form) of the two new train steps' MSDA: MinVIS's
# pixel-decoder encoder (L * P = 12), SeqFormer's encoder and box-form decoder
# over 4 clips x 5 frames
TRAIN_SHAPES = [(MINVIS_TRAIN_LEVELS, 4, 8064, False), (SEQFORMER_TRAIN_LEVELS, 20, 6800, False),
                (SEQFORMER_TRAIN_LEVELS, 20, 300, True)]
TRAIN_SHAPE_IDS = ["minvis-encoder", "seqformer-encoder", "seqformer-decoder"]


def _train_inputs(dev, levels, b, q, box):
    """value, locations and weights at a train step's MSDA shape (M = 8, P =
    4): the encoder's locations as ``_k5_locations`` makes them, the decoder's
    as ``sampling_locations`` makes them of box references."""
    m, p = 8, 4
    if not box:
        return _k4_inputs(dev, levels, b, q, m, p, seed=q + b)
    from vnext_tpu_torch.models.deformable_transformer import sampling_locations

    rng = np.random.RandomState(q + b)
    value = torch.tensor(rng.randn(b, sum(h * w for h, w in levels), m, 32), dtype=torch.bfloat16, device=dev)
    attn = torch.softmax(torch.tensor(rng.randn(b, q, m, len(levels) * p) * 2.0, device=dev).float(),
                         -1).to(torch.bfloat16).view(b, q, m, len(levels), p).contiguous()
    ref = np.concatenate([rng.rand(b, q, len(levels), 2), rng.rand(b, q, len(levels), 2) * 0.5 + 0.02], -1)
    off = torch.tensor(rng.randn(b, q, m, len(levels), p, 2) * 3.0, dtype=torch.bfloat16, device=dev)
    loc = sampling_locations(levels, off, torch.tensor(ref, dtype=torch.float32, device=dev)).contiguous()
    return value, loc, attn


@pytest.mark.cuda
@pytest.mark.parametrize("levels,b,q,box", TRAIN_SHAPES, ids=TRAIN_SHAPE_IDS)
def test_msda_backward_kernel_at_train_shapes(cuda_device, levels, b, q, box):
    """K5 as the new train steps run it: MinVIS-R50's pixel decoder (4 frames,
    Q = S = 8064 over 3 levels coarsest first, L * P = 12: the batches of 4
    samples, not the L * P = 16 fast path) and SeqFormer-R50's encoder and
    box-form decoder over 20 frames, element by element as
    test_msda_backward_kernel_at_sampling_edges holds it."""
    value, loc, attn = _train_inputs(cuda_device, levels, b, q, box)
    grad = torch.tensor(np.random.RandomState(b).randn(b, q, 8 * 32), dtype=torch.bfloat16, device=cuda_device)
    before = ms_deform_attn.KERNEL_V9_BWD.launches
    got = ms_deform_attn.ms_deform_attn_v9_backward(value, levels, loc, attn, grad)
    assert ms_deform_attn.KERNEL_V9_BWD.launches == before + 1
    want = ms_deform_attn.ms_deform_attn_grad_plain(value, levels, loc, attn, grad)
    abs_sums = ms_deform_attn.ms_deform_attn_grad_plain(value.abs(), levels, loc, attn, grad.abs())
    for i in (0, 2):
        g, w, limit = got[i].float(), want[i].float(), abs_sums[i].float()
        excess = (g - w).abs() - (BF16_ULP * w.abs() + 2.0 ** -16 * limit)
        assert float(excess.max()) <= 0.0, (i, float(excess.max()))
    err, scale = _max_err(got[1], want[1])
    assert err <= 1e-5 * scale, err


@pytest.mark.cuda
@pytest.mark.parametrize("levels,b,q,box", TRAIN_SHAPES, ids=TRAIN_SHAPE_IDS)
def test_msda_loc_kernel_at_train_shapes(cuda_device, levels, b, q, box):
    """K4 at the new train steps' shapes against the plain core, within one
    bf16 ulp at the largest output."""
    value, loc, attn = _train_inputs(cuda_device, levels, b, q, box)
    got, launches = _k4_entry("standard", value, levels, loc, attn)
    want = ms_deform_attn.ms_deform_attn_core_plain(value, levels, loc, attn)
    assert launches == 1 and got.shape == (b, q, 8 * 32)
    err, scale = _max_err(got, want)
    assert err <= BF16_ULP * scale, err


@pytest.mark.cuda
def test_epilogue_kernel_at_minvis_tokens(cuda_device):
    """K3 on MinVIS-R50's pixel decoder tokens: 3 frames x 8505 (a ragged last
    tile of 128), FFN 1024."""
    a, src, params = _epilogue_args(cuda_device, 3 * 8505, 1024)
    before = encoder_epilogue.KERNEL.launches
    got = encoder_epilogue.encoder_epilogue(a, src, *params)
    want = encoder_epilogue.encoder_epilogue_plain(a, src, *params)
    assert encoder_epilogue.KERNEL.launches == before + 1
    err, scale = _max_err(got, want)
    assert err <= 2 * BF16_ULP * scale, err


# ---------------------------------------------------------------- K9
def _dynstore_inputs(b, rows, w, starts, seed):
    """x [b, rows, w] bf16 and r [b, 8T, w] f32 whose step t picks row chunk
    ``starts[t]`` (column 0 of its 8 rows sums to starts[t] * T)."""
    rng = np.random.RandomState(seed)
    n_steps = len(starts)
    x = torch.tensor(rng.randn(b, rows, w), dtype=torch.bfloat16)
    r = torch.zeros(b, n_steps * exp_dynstore.ROWS_PER_STEP, w)
    for i, s in enumerate(starts):
        r[:, i * exp_dynstore.ROWS_PER_STEP] = float(s * n_steps)
    return x, r


@pytest.mark.cuda
@pytest.mark.parametrize("b, rows, w, starts, d, block_rows", [
    (2, 128, 128, (0, 1, 2, 0), 8, 4),        # the probe
    (3, 54, 200, (-2, 8, 1, 1, 0), 6, 3),     # a negative start and one clamped at the end; ragged grid
], ids=["probe", "negative-and-clamped"])
def test_dynstore_kernel_equals_plain(cuda_device, b, rows, w, starts, d, block_rows):
    """K9, one thread per output element summing the steps that cover its row in
    step order: bit-equal to the sequential loop. 54 rows and 200 columns leave
    partial blocks on both axes; start -2 * 6 counts from the end (42) and is
    clamped with 8 * 6 = 48 to the last block (36)."""
    x, r = _dynstore_inputs(b, rows, w, starts, seed=len(starts))
    n = len(starts)
    before = exp_dynstore.KERNEL.launches
    got = exp_dynstore.dynstore(x.to(cuda_device), r.to(cuda_device), n, d, block_rows)
    assert exp_dynstore.KERNEL.launches == before + 1
    want = exp_dynstore.dynstore_plain(x, r, n, d, block_rows)
    assert torch.equal(got.cpu(), want)
    exp_dynstore.empty_launch(x.to(cuda_device), n)
    torch.cuda.synchronize()
    assert exp_dynstore.KERNEL.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 6], ids=["plain", "shifted"])
def test_swin_large_stage3_block_card_vs_cpu(cuda_device, shift):
    """One block of Swin-L's stage 3 (768 wide, 24 heads, window 12) on two
    frames at 480x864 (its 30 x 54 map pads to 36 x 60: 150 windows a frame), bf16 on the card against f32 on the CPU on the same weights and the
    same bf16 input: relative L2 within 1% (a block rounds to bf16 about ten
    times in sequence, 2^-9 each, so ~0.5% at most if the errors add like a
    random walk), and the padded and shifted windows leave no non-finite value."""
    from vnext_tpu_torch.models.backbones.swin import SwinBlock
    from vnext_tpu_torch.models.layers import init_weights

    cpu = SwinBlock(768, 24, 12, shift)
    init_weights(cpu, seed=0)
    card = SwinBlock(768, 24, 12, shift, dtype=torch.bfloat16).to(cuda_device)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 30, 54, 768, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    with torch.no_grad():
        got = card(x.to(cuda_device)).float().cpu()
        want = cpu(x.float())
    assert got.shape == want.shape == (2, 30, 54, 768) and torch.isfinite(got).all()
    err = float((got - want).norm() / want.norm())
    assert err <= 0.01, err


# ---------------------------------------------------------------- Swin training, InstMove training, the fused tracker
def _read_config(rel, add):
    import os

    from vnext_tpu_torch.config import get_cfg

    cfg = get_cfg()
    add(cfg)
    cfg.merge_from_file(os.path.join(os.path.dirname(__file__), "..", "configs", rel))
    return cfg


@pytest.mark.cuda
def test_swin_drop_path_on_the_card(cuda_device, monkeypatch):
    """A block of Swin-L's stage 1 (192 wide, window 12) in train mode at rate
    0.3 on 256 frames of 24 x 24 tokens, bf16, drawing from a card generator:
    each of its two draws keeps 1 - 0.3 of the frames within 4 sigma; a
    generator of the same seed draws the same masks and gives the same output
    bit for bit; a frame whose two branches were both dropped comes out equal
    to its input."""
    from vnext_tpu_torch.models.backbones import swin
    from vnext_tpu_torch.models.layers import init_weights

    masks = []
    draw = swin.drop_path_mask
    monkeypatch.setattr(swin, "drop_path_mask", lambda *a: masks.append(draw(*a)) or masks[-1])
    block = swin.SwinBlock(192, 6, 12, 0, drop_path=0.3, dtype=torch.bfloat16)
    init_weights(block, seed=0)
    block = block.to(cuda_device).train()
    x = torch.randn(256, 24, 24, 192, device=cuda_device).to(torch.bfloat16)
    with torch.no_grad():
        a = block(x, torch.Generator(device=cuda_device).manual_seed(4))
        b = block(x, torch.Generator(device=cuda_device).manual_seed(4))
    assert torch.equal(a, b) and all(torch.equal(m, n) for m, n in zip(masks[:2], masks[2:]))
    sigma = (0.3 * 0.7 / 256) ** 0.5
    for m in masks[:2]:
        assert m.shape == (256, 1, 1, 1) and abs(float(m.float().mean()) - 0.7) <= 4 * sigma
    both = ~(masks[0] | masks[1])[:, 0, 0, 0]
    assert both.any() and torch.equal(a[both], x[both])


def _idol_batch(rng, n, hw, k=8):
    h, w = hw
    batch = {}
    for prefix in ("key", "ref"):
        boxes = np.concatenate([rng.rand(n, k, 2) * 0.5 + 0.25, rng.rand(n, k, 2) * 0.3 + 0.1], -1)
        masks = np.zeros((n, k, h // 4, w // 4), bool)
        for j in range(k):
            masks[:, j, 4 * j: 4 * j + 12, 3 * j: 3 * j + 16] = True
        batch.update({f"{prefix}_image": rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8),
                      f"{prefix}_size": np.asarray([[h, w]] * n, np.int32),
                      f"{prefix}_labels": rng.randint(0, 40, (n, k)).astype(np.int32),
                      f"{prefix}_boxes": boxes.astype(np.float32), f"{prefix}_masks_s4": masks,
                      f"{prefix}_valid": np.ones((n, k), bool),
                      f"{prefix}_inst_id": np.tile(np.arange(k, dtype=np.int32), (n, 1))})
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["idol", "seqformer"])
def test_swin_large_train_step_on_the_card(cuda_device, family):
    """The published Swin-L files' train step at full width (drop-path 0.3,
    bf16) on small frames (one clip at 256x320: key + reference for IDOL, 5
    frames for SeqFormer), two steps through ``make_train_step``: finite
    losses, parameters moved, and the MSDA train kernels launched as the
    paths imply (IDOL K4 / K5 = 24 / 24 a step, SeqFormer 12 / 12)."""
    from vnext_tpu_torch.config import add_idol_config, add_seqformer_config
    from vnext_tpu_torch.engine.train_step import TrainState, make_train_step
    from vnext_tpu_torch.solver.build import build_grad_clip, build_lr_scheduler, build_optimizer

    rng = np.random.RandomState(0)
    if family == "idol":
        from vnext_tpu_torch.engine.trainer import PIXEL_MEAN, PIXEL_STD, batch_to_model_inputs
        from vnext_tpu_torch.models.criterion import default_weight_dict
        from vnext_tpu_torch.models.idol import build_idol_model

        cfg = _read_config("idol/ytvis19_swinL.yaml", add_idol_config)
        model = build_idol_model(cfg, device=cuda_device, seed=0)
        weights, per_step = default_weight_dict(dec_layers=cfg.MODEL.IDOL.DEC_LAYERS), 24
        inputs = batch_to_model_inputs(_idol_batch(rng, 1, (256, 320)), PIXEL_MEAN, PIXEL_STD, cuda_device)
    else:
        from vnext_tpu_torch.models.seqformer import ClipTargets, build_seqformer_model, seqformer_weight_dict

        cfg = _read_config("seqformer/swin_ytvis.yaml", add_seqformer_config)
        model = build_seqformer_model(cfg, device=cuda_device, seed=0)
        weights, per_step, nf, k = seqformer_weight_dict(cfg), 12, 5, 6
        masks = np.zeros((1, k, nf, 64, 80), bool)
        for j in range(k):
            masks[0, j, :, 4 * j: 4 * j + 12, 3 * j: 3 * j + 16] = True
        boxes = np.concatenate([rng.rand(1, k, nf, 2) * 0.5 + 0.25, rng.rand(1, k, nf, 2) * 0.3 + 0.1], -1)
        targets = ClipTargets(*(torch.from_numpy(a).to(cuda_device) for a in (
            rng.randint(0, 40, (1, k)).astype(np.int32), boxes.astype(np.float32), masks, np.ones((1, k), bool))))
        inputs = (torch.randn(1, nf, 256, 320, 3, device=cuda_device),
                  torch.tensor([[256, 320]], dtype=torch.int32, device=cuda_device), targets)
    assert model.backbone.layers_3_blocks_1.drop_path == pytest.approx(0.3)     # the last block's rate
    optimizer = build_optimizer(cfg, model)
    state = TrainState.create(model, optimizer, build_lr_scheduler(cfg, optimizer))
    step = make_train_step(model, optimizer, weights, build_grad_clip(cfg))
    before = model.backbone.layers_0_blocks_1.attn.qkv.weight.detach().clone()
    launches = (ms_deform_attn.KERNEL_V9_FWD.launches, ms_deform_attn.KERNEL_V9_BWD.launches)
    for _ in range(2):
        state, metrics = step(state, inputs)
        assert all(torch.isfinite(v).all() for v in metrics.values())
    torch.cuda.synchronize()
    assert ms_deform_attn.KERNEL_V9_FWD.launches - launches[0] == 2 * per_step
    assert ms_deform_attn.KERNEL_V9_BWD.launches - launches[1] == 2 * per_step
    assert not torch.equal(before, model.backbone.layers_0_blocks_1.attn.qkv.weight)


@pytest.mark.cuda
def test_train_instmove_on_the_card(cuda_device, tmp_path):
    """``train_instmove`` at full width (memory 100, 4 ConvLSTM layers of 128,
    f32) on a synthetic YTVIS dataset of 2 videos x 8 frames: 2 steps of 2
    samples at 64x64 on the card, finite losses, ``instmove_final`` written."""
    import os

    from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_ytvis
    from vnext_tpu_torch.tools import train_instmove

    name = "ytvis_synthetic_instmove_card"
    register_synthetic_ytvis(name, root=str(tmp_path / name), num_frames=8)
    config = os.path.join(os.path.dirname(__file__), "..", "configs", "minvis", "ovis_r50_motion.yaml")
    model, storage = train_instmove.main([
        "--config-file", config, "DATASETS.TRAIN", f"('{name}',)", "OUTPUT_DIR", str(tmp_path / "out"),
        "SOLVER.MAX_ITER", "2", "SOLVER.IMS_PER_BATCH", "2", "MODEL.INSTMOVE.MASK_SIZE", "[64, 64]"])
    assert next(model.parameters()).is_cuda and model.dtype == torch.float32
    assert np.isfinite(storage.history("total_loss").values()).all()
    assert (tmp_path / "out" / "instmove_final.pth").exists()


@pytest.mark.cuda
def test_device_tracker_on_the_card_equals_the_cpu_without_a_sync(cuda_device):
    """The fused runner's tracker step (long-term memory, frame and temporal
    weights) over a random episode of 12 frames x 64 detections at 120x216
    masks, on the card with the sync debug mode raising on any copy to the
    host, and on the CPU: ids, keeps and every state leaf equal (floats within
    rtol 1e-5: the same f32 formulas, other reduction orders)."""
    from vnext_tpu_torch.tracking import idol_tracker_device as dt

    rng = np.random.RandomState(0)
    nd, c = 64, 256
    kw = dict(nms_thr_pre=0.5, nms_thr_post=0.05, init_score_thr=0.2, addnew_score_thr=0.2, match_score_thr=0.5,
              memo_tracklet_frames=10, memo_momentum=0.8, long_match=True, frame_weight=True,
              temporal_weight=True)
    obj = rng.randn(12, c).astype(np.float32) * 3
    card, cpu = dt.init_state(32, nd, c, device=cuda_device), dt.init_state(32, nd, c)
    for fid in range(12):
        which = rng.randint(0, 12, nd)
        boxes = rng.rand(nd, 5).astype(np.float32)
        masks = np.zeros((nd, 120, 216), bool)
        for i, o in enumerate(which):
            masks[i, 10 * (o % 6): 10 * (o % 6) + 20 + rng.randint(4), 36 * (o // 6): 36 * (o // 6) + 30] = True
        args = [torch.from_numpy(a) for a in (boxes, rng.randint(0, 40, nd), masks,
                                              obj[which] + 0.3 * rng.randn(nd, c).astype(np.float32),
                                              rng.rand(nd) > 0.1)]
        cpu, ids, keep = dt.tracker_step(cpu, *args, fid, **kw)
        on_card = [a.to(cuda_device) for a in args]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card, card_ids, card_keep = dt.tracker_step(card, *on_card, fid, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(card_ids.cpu(), ids) and torch.equal(card_keep.cpu(), keep), fid
        for name in dt.TrackerState._fields:
            got, want = getattr(card, name).cpu(), getattr(cpu, name)
            if want.dtype.is_floating_point:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            else:
                assert torch.equal(got, want), (fid, name)
    assert int(cpu.num_tracklets) >= 4


def _operator_cases(dev):
    """Each kernel's operator (torch.ops.vnext.*) at one shape: (name, the
    operator's arguments, its plain version's output, the kernel's counter, the
    tolerance as a multiple of one bf16 ulp at the largest output)."""
    rng = np.random.RandomState(21)
    levels = ((16, 32), (8, 16), (4, 8), (1, 1))
    flat = ms_deform_attn.flat_shapes(levels)
    off, ref = _edge_samples(levels, 301, 8, 4, False, rng)
    s, bf16 = sum(h * w for h, w in levels), torch.bfloat16
    value = torch.tensor(rng.randn(1, s, 8, 32), dtype=bf16, device=dev)
    off, ref = torch.tensor(off, dtype=bf16, device=dev), torch.tensor(ref, dtype=torch.float32, device=dev)
    logits = torch.tensor(rng.randn(1, 301, 8, 16) * 2.0, dtype=bf16, device=dev)
    k4_value, loc, attn = _k4_inputs(dev, levels, 2, 301, 8, 4, seed=5)
    a, src, params = _epilogue_args(dev, 129, 1024)
    stem = _stem_args(dev, (2, 38, 70, 3))
    return [
        ("msda_fwd", (value, off, ref, logits, flat),
         ms_deform_attn.ms_deform_attn_plain(value, levels, off, ref, logits), ms_deform_attn.KERNEL, 1),
        ("msda_fwd_loc", (k4_value, loc, attn, flat, "pallas_v9"),
         ms_deform_attn.ms_deform_attn_core_plain(k4_value, levels, loc, attn), ms_deform_attn.KERNEL_V9_FWD, 1),
        ("encoder_epilogue", (a, src, *params), encoder_epilogue.encoder_epilogue_plain(a, src, *params),
         encoder_epilogue.KERNEL, 2),
        ("stem_conv", tuple(stem), stem_conv.stem_conv_plain(*stem), stem_conv.KERNEL, 1),
    ]


@pytest.mark.cuda
def test_operators_run_their_kernels(cuda_device):
    """torch.ops.vnext.* on CUDA tensors: one launch of the hand-written kernel
    per call (counted inside the operator's CUDA implementation), the output
    within the kernel tests' limits of the plain version; a misaligned view
    raises inside the operator before any launch."""
    for name, args, want, kernel, ulps in _operator_cases(cuda_device):
        op = getattr(torch.ops.vnext, name)
        before = kernel.launches
        got = op(*args)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, name
        assert got.shape == want.shape and got.dtype == want.dtype, name
        err, scale = _max_err(got, want)
        assert err <= ulps * BF16_ULP * scale, (name, err)
        first = args[0]
        flat = torch.zeros(first.numel() + 8, dtype=first.dtype, device=cuda_device)
        shifted = flat[1:first.numel() + 1].view_as(first).copy_(first)
        with pytest.raises(ValueError, match="16-byte"):
            op(shifted, *args[1:])
        assert kernel.launches == before + 1, name
