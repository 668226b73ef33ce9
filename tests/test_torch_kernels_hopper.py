"""K2 (the stem as an implicit GEMM on the tensor cores) and K1 (the fused MSDA
forward, one warp per query with 16-byte corner loads) against their plain
versions on the card, at the edges of their tilings and sampling rules.

Every test here needs a CUDA device (``cuda`` marker; skipped without one):
``python -m pytest -m cuda tests/test_torch_kernels_hopper.py``. This file
imports nothing of the JAX package, so it runs where flax is not installed.
The stem's K packing, which the CPU reaches, is held against the JAX package
in ``tests/test_torch_stem_conv.py``.
"""

import numpy as np
import pytest
import torch

from vnext_tpu_torch.ops import ms_deform_attn, stem_conv

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
        stem_conv.stem_conv7x7s2_bn_relu(x[:, :7], k, scale, bias)
    assert stem_conv.KERNEL.launches == before


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
