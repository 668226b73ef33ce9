#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``vnext_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                          # every phase
    python3 chip_smoke.py --only train_numerics    # phases 1 and 6 alone

Phases, each printed as it ends; any failure raises and exits non-zero. Each
path zeroes every kernel's launch counter just before it runs and reads them
all just after; the counts must be what the code implies.

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions, and
   the build of the hand-written kernels from ``vnext_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch version on the card, with the
   tolerance stated beside the error, both times (CUDA events, median of 10
   after warm-up), the least time the card could take for the same work, and
   the time of one PyTorch library call that computes the same function where
   there is one. 2a: K1-K3 at IDOL-R50's serving shapes, with K1's rate of
   gathered corner rows (in-range corners x 64 B over its time) and K3's
   TFLOP/s beside its yardstick, cuBLAS's two bf16 products alone; K1's fused
   entry and K3 refuse autograd. 2b: K4, K5 (held element by element, with its
   value-gradient reduction traffic: in-range corners x 128 B over its time),
   the v6 route's backward (K5 through ``TPU.MSDA_IMPL`` "pallas") and K2's
   forward and backward at the train step's shapes. 2c: K4 and the selector's routes
   ("pallas", "pallas_v7", "pallas_v8") at the serving encoder and decoder
   shapes (the decoder's is SeqFormer's), K4b (the channel-major entry) at the
   encoder's, and K9 at its own beside an empty kernel launched on its grid
   (the launch floor). 2d: the two kernels no model path runs, through their
   entry points: ``ms_deform_attn_cm`` once and the K9 probe.
3. The serving path: IDOL-R50 (40 classes, 300 queries, 6 + 6 layers, hidden
   256, bf16, seeded random weights) through ``IDOLVideoInference`` on two
   synthetic videos of 20 and 13 frames at 480x853 (clips of 10 padded to
   480x864). The launch counters must read K1 / K2 / K3 = 12 / 1 / 6 per clip,
   all outputs must be finite and the ``results.json`` entries well-formed.
   Then the forward alone on a clip already on the card, and its device time
   by kernel (``torch.profiler``).
4. Frame 0 of the first video through the port on the card (kernels, bf16) and
   on the CPU (plain versions, f32), compared within stated tolerances.
9. IDOL-R50 serving on one clip under each of the routes "pallas",
   "pallas_v7", "pallas_v8": the route's counter and K4's at 12 per clip, K1's
   at 0, the outputs within 2% of the "auto" run on the same weights.
7. SeqFormer-R50 (the same trunk, 300 queries, bf16, seeded random weights)
   through ``SeqFormerVideoInference`` on the same two videos whole and the
   13-frame one clip-matched in windows of 5: per clip K2 / K1 / K3 / K4 =
   1 / 6 / 6 / 6; per-clip and forward times, the device's busy share.
8. A 2-frame clip of SeqFormer on the card (bf16) and on the CPU (f32).
5. The train path: IDOL-R50 at the same widths, bf16, dropout 0.1, through
   ``VISTrainer.train`` with its hooks, on seeded synthetic batches of 4 clips
   (key + reference frame at 512x640, up to 48 instances with boxes and
   stride-4 masks) under the ytvis19_r50 solver: one warm-up step and 5 timed
   ones. Every loss must be finite, every trainable parameter must change and
   every frozen one stay bit-equal, and the launch counters must read
   K4 / K5 / K2 = 24 / 24 / 2 per step. Then the step's forward / backward /
   update split, peak memory, and device time by kernel (``torch.profiler``).
6. One clip (key + reference) at 512x640 through ``forward_single`` in train
   mode with dropout 0, on the card (kernels, bf16) and on the CPU (plain
   versions, f32): a seeded random projection of the last layer's logits,
   boxes and hidden states, and its gradients by parameter group, compared
   within stated tolerances. It prints |value| beside the sum of the terms'
   |values| (how much the signed sum cancels) and each projected output's
   relative L2, and a second projection whose weights take the sign of the
   CPU's outputs, so that no term cancels, held at 5% too. Alone
   (``--only train_numerics``) it can import the package
   from another checkout (``--tree``, to bisect a move across commits) and
   rerun the card's forward with K2's or K4's plain version on the card
   (``--swap-plain``).
10. Two IDOL-R50 train steps under "pallas": the v6 route's forward and
    backward counters at 24 each per step beside K4's and K5's.
11. MinVIS-R50 serving (Mask2Former: 25 classes, 100 queries, 6 pixel-decoder
    layers over 3 levels coarsest first, 9 masked-attention decoder layers,
    hidden 256, bf16, seeded random weights) through ``MinVISVideoInference``
    in windows of 3 on the same two videos: per window K2 / K1 / K3 = 1 / 6 /
    6 and no K4 or K5 (K1 and K3 first held against their plain versions at
    a window's shapes); outputs finite, ``results.json`` entries well-formed;
    per-video ms; then the forward alone at bench.py's ``bench_minvis`` shape
    (10 frames at 480x864), its device busy share and time by kernel.
12. One frame of MinVIS on the card (kernels, bf16) and on the CPU (plain,
    f32): logits, embeddings and masks within 5%, and the share of attention-
    mask bits that differ by decoder layer.
13. InstMove (memory 100, 4 ConvLSTM layers of 128 channels) at bench.py's
    ``bench_instmove`` shape (bf16, B = 32, 4 past masks at 128x128): K2 once
    per call, output finite, ms per call; card vs CPU at B = 2 within 5%; and
    the motion-fused MinVIS runner at 480x864 must raise its ValueError (its
    120x216 masks are not multiples of 16, where the JAX package fails too).
    The seconds of phases 11-13 are printed.

Then a JSON line with the slices' times, one with every kernel's launches,
error, times and bound, and last ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, when no CUDA device is visible. Imports neither
jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

BF16_ULP = 2.0 ** -7          # spacing of bf16 values in [1, 2)
# f32 summation-order noise, as a share of an element's sum of |terms|: a few
# hundred terms summed in two orders differ by ~sqrt(n) * 2^-24 of it, ~2^-20
F32_SUM_NOISE = 2.0 ** -16
LEVELS = ((60, 108), (30, 54), (15, 27), (8, 14))   # IDOL-R50 at 480x864, strides 8..64
CLIP, HEIGHT, WIDTH = 10, 480, 864
VIDEO_HW = (480, 853)
VIDEO_FRAMES = (20, 13)
SEQ_CLIP_LENGTH = 5           # MODEL.SeqFormer.CLIP_LENGTH of configs/seqformer/ytvis19_r50.yaml

# the train step: TPU.TRAIN_IMAGE_SIZE and MAX_INSTANCES of configs/idol/ytvis19_r50.yaml,
# and bench.py's single-chip share of its 32-clip batch
TRAIN_CLIPS, TRAIN_HW, MAX_INSTS = 4, (512, 640), 48
TRAIN_LEVELS = ((64, 80), (32, 40), (16, 20), (8, 10))
TRAIN_STEPS = 6                      # one warm-up step, then 5 timed
# SOLVER of configs/idol/ytvis19_r50.yaml, with the JAX package's defaults
# (vnext_tpu/config/defaults.py) where the file sets none
SOLVER = SimpleNamespace(
    OPTIMIZER="ADAMW", BASE_LR=1e-4, WEIGHT_DECAY=1e-4, BACKBONE_MULTIPLIER=0.1,
    LR_SCHEDULER_NAME="WarmupMultiStepLR", STEPS=(8000,), GAMMA=0.1, MAX_ITER=12000,
    WARMUP_FACTOR=1.0, WARMUP_ITERS=10,
    CLIP_GRADIENTS=SimpleNamespace(ENABLED=True, CLIP_TYPE="full_model", CLIP_VALUE=0.01),
)

# published H100 SXM peaks at 700 W (NVIDIA's data sheet): HBM bytes/s and
# dense operations/s by operand type
H100_BYTES_PER_S = 3.35e12
H100_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, kind: str):
    """The least time the card could take: the larger of moving ``nbytes`` at the
    HBM rate and doing ``ops`` at the peak rate for ``kind`` operands."""
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = ops / H100_OPS_PER_S[kind] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def samples_in_range(pix, levels, strict: bool) -> int:
    """Samples [.., L, P, 2] (pixel coordinates) with a corner inside their level:
    the work an MSDA kernel does, since it skips the others whole."""
    import torch

    wh = torch.tensor([[w, h] for h, w in levels], dtype=pix.dtype, device=pix.device)[:, None, :]
    inside = ((pix > -1) if strict else (pix >= -1)) & (pix < wh)
    return int(inside.all(-1).sum())


def corners_in_range(pix, levels, strict: bool = True) -> int:
    """Corners inside their level of the samples an MSDA kernel does not skip
    (pixel coordinates [.., L, P, 2]): the head rows it must gather (and, in the
    backward, which also keeps samples at exactly -1 (``strict=False``), the
    head rows of the value gradient it must add to)."""
    import torch

    wh = torch.tensor([[w, h] for h, w in levels], dtype=pix.dtype, device=pix.device)[:, None, :]
    sample_in = (((pix > -1) if strict else (pix >= -1)) & (pix < wh)).all(-1)
    lo = torch.floor(pix)
    n = 0
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        c = lo + torch.tensor([dx, dy], dtype=pix.dtype, device=pix.device)
        n += int((sample_in & ((c >= 0) & (c < wh)).all(-1)).sum())
    return n


def gathered(pix, levels, ms) -> str:
    """An MSDA forward's gather at pixel coordinates [.., L, P, 2]: its in-range
    corners, one 64-byte head row each, and their rate over ``ms``."""
    corners = corners_in_range(pix, levels)
    return (f"{corners} in-range corners x 64 B = {corners * 64 / 1e9:.4f} GB gathered at "
            f"{corners * 64 / (ms * 1e-3) / 1e12:.4f} TB/s")


def backward_reductions(pix, levels):
    """K5's value-gradient reductions for samples at pixel coordinates [B, Q,
    M, L, P, 2]: the corners inside their level with a non-zero bilinear weight
    (one 128-byte reduction each), and how many distinct (query, head, level,
    token) they hit, which is what merging a head's corners that repeat within
    a level would leave."""
    import torch

    b, q, m, n_l, p, _ = pix.shape
    wh = torch.tensor([[w, h] for h, w in levels], dtype=pix.dtype, device=pix.device)[:, None, :]
    starts = torch.tensor(np.cumsum([0] + [h * w for h, w in levels])[:-1], device=pix.device)
    s_total = sum(h * w for h, w in levels)
    sample_in = ((pix >= -1) & (pix < wh)).all(-1)
    lo = torch.floor(pix)
    frac = pix - lo
    head = torch.arange(b * q * m, device=pix.device).view(b, q, m, 1, 1)
    level = torch.arange(n_l, device=pix.device).view(1, 1, 1, n_l, 1)
    keys = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        c = lo + torch.tensor([dx, dy], dtype=pix.dtype, device=pix.device)
        wx = frac[..., 0] if dx else 1 - frac[..., 0]
        wy = frac[..., 1] if dy else 1 - frac[..., 1]
        ok = sample_in & ((c >= 0) & (c < wh)).all(-1) & (wx * wy != 0)
        tok = starts.view(1, 1, 1, n_l, 1) + c[..., 1].long() * wh[:, 0, 0].long().view(1, 1, 1, n_l, 1) \
            + c[..., 0].long()
        keys.append(((head * n_l + level) * s_total + tok)[ok])
    keys = torch.cat(keys)
    return keys.numel(), torch.unique(keys).numel()


def kernel_entry(err, ms, plain_ms, bound, library_ms=None):
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def compare(name, got, want, tol, reason):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    print(f"  {name}: max_abs_err {err:.6g} (max_rel {err / max(scale, 1e-30):.3g}) "
          f"tolerance {tol:.6g}: {reason}")
    require(err <= tol, f"{name}: error {err} above tolerance {tol}")
    return err


def compare_each(name, got, want, abs_sum):
    """Element by element: |got - want| <= one bf16 ulp of |want| plus
    F32_SUM_NOISE of the element's sum of |terms| (``abs_sum``). Both sides are
    an f32 sum of the same products rounded once to bf16: two such roundings
    that differ are neighbours, one ulp of the smaller apart. Returns the
    largest absolute error."""
    diff = (got.float() - want.float()).abs()
    limit = BF16_ULP * want.float().abs() + F32_SUM_NOISE * abs_sum.float()
    over = int((diff > limit).sum())
    err = float(diff.max())
    worst = float((diff / limit.clamp_min(1e-30)).max())
    rel_l2 = float((got.float() - want.float()).norm() / want.float().norm())
    print(f"  {name}: max_abs_err {err:.6g}, relative L2 {rel_l2:.3g}; element by element within "
          f"one bf16 ulp of |want| + 2^-16 of its sum of |terms| (worst element at {worst:.3g} of "
          f"its limit): both round an f32 sum of the same products to bf16 once, in other orders")
    require(over == 0, f"{name}: {over} elements above their limit (worst {worst:.3g}x)")
    return err


# the device functions of csrc/, as the profiler names them
HAND_WRITTEN = ("msda_fwd_kernel", "msda_fwd_loc_kernel", "msda_fwd_loc_cm_kernel", "msda_bwd_kernel",
                "f32_to_bf16_kernel", "stem_conv_kernel", "encoder_epilogue_kernel", "dynstore_kernel")


def profile_busy(fn, what: str, calls: int = 2, top: int = 12):
    """Device time per call of ``fn`` by kernel (``torch.profiler``, CUDA rows
    only, annotated regions dropped), after one call of warm-up; prints the top
    kernels, returns (busy ms, wall ms under the profiler) per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / calls
    events.sort(key=lambda e: -e.self_device_time_total)
    print(f"  torch.profiler, {what}: device busy {busy:.2f} ms per call of {wall:.2f} ms wall under the "
          f"profiler ({busy / wall:.1%}); top kernels, ms per call:")
    print_kernel_rows(events, calls, top)
    return busy, wall


def print_kernel_rows(events, calls: int, top: int):
    """The ``top`` kernels by device time per call, then the hand-written ones below them."""
    ours = [e for e in events[top:] if any(k in e.key for k in HAND_WRITTEN)]
    for i, e in enumerate(events[:top] + ours):
        if i == top:
            print("  and the hand-written kernels below them:")
        print(f"    {e.self_device_time_total / 1e3 / calls:9.3f} ms  {e.count // calls:6d} calls  {e.key[:110]}")


# ---------------------------------------------------------------- phase 1
def phase_card():
    import torch

    from vnext_tpu_torch._build import load_library

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    lib = load_library()
    print(f"[phase 1] kernels built in {lib.build_seconds:.1f} s: {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    return smi


def epilogue_case(t, rng, b: int, s: int, label: str):
    """K3 against its plain version on [b, s, 256] tokens with FFN 1024, drawn
    from ``rng``, with its time beside cuBLAS's two products alone. Returns the
    kernel entry and the inputs (attn, src, params)."""
    import torch

    from vnext_tpu_torch.ops import encoder_epilogue as epi

    bf16 = torch.bfloat16
    c, f = 256, 1024
    attn = t(rng.randn(b, s, c) * 0.5, bf16)
    src = t(rng.randn(b, s, c), bf16)
    params = (t(rng.rand(c) + 0.5), t(rng.randn(c) * 0.1), t(rng.randn(f, c) * 0.06),
              t(rng.randn(f) * 0.1), t(rng.randn(c, f) * 0.03), t(rng.randn(c) * 0.1),
              t(rng.rand(c) + 0.5), t(rng.randn(c) * 0.1))
    got = epi.encoder_epilogue(attn, src, *params)
    want = epi.encoder_epilogue_plain(attn, src, *params)
    torch.cuda.synchronize()
    err = compare(f"K3 encoder_epilogue {label}", got, want,
                  2 * BF16_ULP * float(want.float().abs().max()),
                  "two bf16 ulps at the largest output: one for the final rounding, one for the "
                  "intermediate roundings the plain version takes elsewhere (bf16 outputs of both "
                  "products; the kernel rounds only the ReLU activation)")
    plain_ms = time_ms(lambda: epi.encoder_epilogue_plain(attn, src, *params))
    ms = time_ms(lambda: epi.encoder_epilogue(attn, src, *params))
    flops = 2.0 * 2 * src.numel() * f
    bound = bound_ms(nbytes(attn, src, got, *params), flops, "bf16")
    # the yardstick: K3's two products alone as cuBLAS runs them (bf16 F.linear
    # with bias, the [N, F] intermediate in device memory, no LayerNorm or ReLU)
    h = src.view(-1, c)
    w1b, b1b, w2b, b2b = (x.to(bf16) for x in (params[2], params[3], params[4], params[5]))
    library_ms = time_ms(lambda: torch.nn.functional.linear(torch.nn.functional.linear(h, w1b, b1b), w2b, b2b))
    print(f"  K3 {label} kernel {ms:.4f} ms ({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s), plain {plain_ms:.4f} ms "
          f"(bf16 F.linear), cuBLAS's two bf16 F.linear alone {library_ms:.4f} ms "
          f"({flops / (library_ms * 1e-3) / 1e12:.1f} TFLOP/s), bound {bound[0]:.4f} ms by {bound[1]}")
    return kernel_entry(err, ms, plain_ms, bound, library_ms), (attn, src, params)


# ---------------------------------------------------------------- phase 2
def phase_kernels(dev):
    import torch

    from vnext_tpu_torch.ops import encoder_epilogue as epi
    from vnext_tpu_torch.ops import ms_deform_attn as msda
    from vnext_tpu_torch.ops import stem_conv as stem

    rng = np.random.RandomState(0)
    bf16 = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)

    results = {}
    b, m, d, l, p = CLIP, 8, 32, 4, 4
    s = sum(h * w for h, w in LEVELS)

    # value with zeroed padding (the last column of every level, as a 853-wide frame pads)
    value = rng.randn(b, s, m, d)
    start = 0
    for h, w in LEVELS:
        value[:, start + np.arange(h) * w + (w - 1)] = 0.0
        start += h * w
    value = t(value, bf16)

    def msda_case(form, q, ref, offsets):
        logits = t(rng.randn(b, q, m, l * p) * 2.0, bf16)
        args = (value, LEVELS, offsets, ref, logits)
        got = msda.ms_deform_attn(*args)
        want = msda.ms_deform_attn_plain(*args)
        torch.cuda.synchronize()
        tol = BF16_ULP * float(want.float().abs().max())
        err = compare(f"K1 ms_deform_attn_fwd ({form}, Q={q})", got, want, tol,
                      "one bf16 ulp at the largest output: both sum the same bf16 inputs in f32 "
                      "and round once to bf16, in different orders")
        plain_ms = time_ms(lambda: msda.ms_deform_attn_plain(*args))
        ms = time_ms(lambda: msda.ms_deform_attn(*args))
        # ~10 f32 operations per (sample inside its level, channel): 4 corner
        # weights, 4 products and sums, the attention weight
        pix = msda.pixel_locations(LEVELS, offsets, ref)
        n = samples_in_range(pix, LEVELS, strict=True)
        bound = bound_ms(nbytes(value, offsets, ref, logits, got), 10.0 * n * d, "f32")
        print(f"  K1 ({form}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound[0]:.4f} ms by {bound[1]}; no single library call computes MSDA; "
              f"{gathered(pix, LEVELS, ms)}")
        return kernel_entry(err, ms, plain_ms, bound)

    # encoder form: Q = S grid references; integer offsets put samples exactly on
    # pixel centres, a few offsets land far outside every level
    ref_pts = []
    for h, w in LEVELS:
        yy, xx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        ref_pts.append(np.stack([xx.ravel(), yy.ravel()], -1))
    ref_enc = np.broadcast_to(np.concatenate(ref_pts)[None, :, None, :], (b, s, l, 2))
    off = rng.randn(b, s, m, l, p, 2) * 3.0
    off[..., 0, :] = np.round(off[..., 0, :])
    far = rng.rand(b, s, m, l, p) < 0.02
    off[far] = rng.choice([-300.0, 300.0], size=(far.sum(), 2))
    results["enc"] = msda_case("encoder point form", s, t(ref_enc), t(off, bf16))

    # decoder box form: Q = 300 boxes (cx, cy, w, h)
    q = 300
    boxes = np.concatenate([rng.rand(b, q, 1, 2), rng.rand(b, q, 1, 2) * 0.45 + 0.05], -1)
    ref_dec_t = t(np.broadcast_to(boxes, (b, q, l, 4)))
    offsets_dec = t(rng.randn(b, q, m, l, p, 2) * 3.0, bf16)
    logits_dec = t(rng.randn(b, q, m, l * p), bf16)
    results["dec"] = msda_case("decoder box form", q, ref_dec_t, offsets_dec)

    # K2 stem
    x = t(rng.randn(CLIP, HEIGHT, WIDTH, 3))
    k = t(rng.randn(7, 7, 3, 64) * 0.1)
    scale, bias = t(rng.rand(64) + 0.5), t(rng.randn(64) * 0.1)
    got = stem.stem_conv7x7s2_bn_relu(x, k, scale, bias)
    want = stem.stem_conv_plain(x, k, scale, bias)
    torch.cuda.synchronize()
    err = compare("K2 stem_conv [10,480,864,3]", got, want, BF16_ULP * float(want.float().abs().max()),
                  "one bf16 ulp at the largest output: both sum exact products of bf16-rounded "
                  "operands in f32 and round once to bf16, in different orders")
    plain_ms = time_ms(lambda: stem.stem_conv_plain(x, k, scale, bias))
    ms = time_ms(lambda: stem.stem_conv7x7s2_bn_relu(x, k, scale, bias))
    # the library's convolution alone (cuDNN, bf16, channels-last), without the affine and ReLU
    xb = x.to(bf16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    kb = k.to(bf16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    library_ms = time_ms(lambda: torch.nn.functional.conv2d(xb, kb, stride=2, padding=3))
    bound = bound_ms(nbytes(x, k, scale, bias, got), 2.0 * got.numel() * 7 * 7 * 3, "bf16")
    print(f"  K2 kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (f32 conv of bf16-rounded operands, TF32 off), "
          f"cuDNN bf16 conv2d {library_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]}")
    results["stem"] = kernel_entry(err, ms, plain_ms, bound, library_ms)

    # K3 encoder epilogue
    results["epilogue"], (attn, src, params) = epilogue_case(t, rng, CLIP, s, f"[{CLIP},{s},256]")

    # K1's fused entry and K3 are inference-only, as on the TPU: under autograd they raise
    for name, call in (
        ("K1 ms_deform_attn (fused entry)",
         lambda: msda.ms_deform_attn(value.clone().requires_grad_(), LEVELS, offsets_dec, ref_dec_t, logits_dec)),
        ("K3 encoder_epilogue", lambda: epi.encoder_epilogue(attn, src, params[0].clone().requires_grad_(), *params[1:])),
    ):
        try:
            call()
        except RuntimeError as exc:
            require("inference-only" in str(exc), f"{name}: unexpected error {exc}")
            print(f"  {name} under autograd raises: {exc}")
        else:
            raise SmokeFailure(f"{name} ran under autograd instead of raising")
    print("[phase 2a] every serving kernel agrees with its plain version at serving shapes")
    return results


# ---------------------------------------------------------------- phase 3
def synthetic_video(seed: int, n_frames: int):
    """uint8 frames [T, H, W, 3]: coloured rectangles moving over a noisy background."""
    rng = np.random.RandomState(seed)
    h, w = VIDEO_HW
    frames = np.empty((n_frames, h, w, 3), np.uint8)
    n_obj = 4
    pos = rng.rand(n_obj, 2) * [h * 0.6, w * 0.6]
    vel = rng.randn(n_obj, 2) * 6.0
    size = rng.rand(n_obj, 2) * [h * 0.3, w * 0.3] + 40
    color = rng.randint(0, 256, (n_obj, 3))
    for i in range(n_frames):
        img = rng.randint(0, 40, (h, w, 3)).astype(np.uint8)
        for o in range(n_obj):
            y0, x0 = (pos[o] + vel[o] * i).astype(int)
            y0, x0 = np.clip(y0, 0, h - 1), np.clip(x0, 0, w - 1)
            y1, x1 = int(min(h, y0 + size[o, 0])), int(min(w, x0 + size[o, 1]))
            img[y0:y1, x0:x1] = color[o]
        frames[i] = img
    return frames


def phase_main_path(dev, kernels):
    import torch

    from vnext_tpu_torch.engine.vis_inference import IDOLVideoInference
    from vnext_tpu_torch.evaluation.ytvis_json import video_output_to_json
    from vnext_tpu_torch.models.idol import build_idol_model

    t0 = time.perf_counter()
    model = build_idol_model(device=dev, seed=0)
    print(f"  IDOL-R50 built in {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters, dtype {model.dtype}, "
          "seeded random weights (MODEL.WEIGHTS is not in the repository)")

    videos = {vid: synthetic_video(vid, n) for vid, n in zip((1, 2), VIDEO_FRAMES)}
    store = {f"v{vid}/{i:05d}.jpg": fr for vid, frames in videos.items() for i, fr in enumerate(frames)}
    runner = IDOLVideoInference(model, image_loader=store.__getitem__)

    clip_ms, outputs_finite = [], []
    infer = runner.infer_clip

    def timed_clip(frames, size):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = infer(frames, size)
        clip_ms.append((time.perf_counter() - t1) * 1e3)
        outputs_finite.append(all(np.isfinite(v).all() for v in out.values()))
        return out

    records = [
        {"video_id": vid, "height": VIDEO_HW[0], "width": VIDEO_HW[1], "length": len(frames),
         "file_names": [f"v{vid}/{i:05d}.jpg" for i in range(len(frames))]}
        for vid, frames in videos.items()
    ]
    # Random weights score every query alike (~0.07), below the tracker's 0.2 birth
    # threshold, so no track would start and the writer would get no work. Raise
    # the bias of class 0 so that a tenth of the queries of the first clip score
    # 0.3 on it: the tracker, the mask assembly and the writer then run for real.
    first_clip = {**records[0], "file_names": records[0]["file_names"][:CLIP]}
    probe = infer(*runner._prepare_frames(first_clip))["pred_logits"][..., 0]
    shift = float(np.log(0.3 / 0.7) - np.quantile(probe, 0.9))
    with torch.no_grad():
        getattr(model, f"class_embed_{model.dec_layers - 1}").bias[0] += shift
    print(f"  class-0 bias raised by {shift:.3f} so that random weights make detections")

    runner.infer_clip = timed_clip
    # one warm-up video, not counted: first launches pay the library load and cuDNN / cuBLAS planning
    runner(records[1])
    clip_ms.clear()
    outputs_finite.clear()

    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    results = [(rec, runner(rec)) for rec in records]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}

    n_clips = sum(-(-len(f) // CLIP) for f in videos.values())
    expected = {"ms_deform_attn_fwd": 12 * n_clips, "stem_conv": 1 * n_clips,
                "encoder_epilogue": 6 * n_clips}
    print(f"  launches over {n_clips} clips: {launches} (expected {expected})")
    require(launches == expected, f"launch counts {launches} != {expected}")
    require(len(outputs_finite) == n_clips and all(outputs_finite), "non-finite model outputs")

    entries = []
    for rec, out in results:
        js = video_output_to_json(out, rec["video_id"])
        for e in js:
            require(set(e) == {"video_id", "score", "category_id", "segmentations"}, f"entry keys {set(e)}")
            require(0.0 <= e["score"] <= 1.0 and 1 <= e["category_id"] <= 40, f"bad entry {e['score']}")
            require(len(e["segmentations"]) == rec["length"], "one segmentation per frame")
            require(all(sg["size"] == list(VIDEO_HW) and isinstance(sg["counts"], str)
                        for sg in e["segmentations"]), "RLE size / counts")
        entries += js
    require(len(entries) > 0, "no results.json entries: the tracker started no track")
    json.dumps(entries)

    # the forward alone, on a clip already on the card (no host copies)
    frames, size = runner._prepare_frames(first_clip)
    with torch.inference_mode():
        x = (torch.from_numpy(frames).to(dev).float() - runner.pixel_mean) / runner.pixel_std
        sizes = torch.tensor([size] * CLIP, dtype=torch.int32, device=dev)
        forward_ms = time_ms(lambda: model.inference(x, sizes), reps=10, warmup=2)
        busy_ms, _ = profile_busy(lambda: model.inference(x, sizes), f"IDOL-R50 serving forward ({CLIP}-frame clip)")
    timing = {"clip_ms": statistics.median(clip_ms), "forward_ms": forward_ms, "device_busy_ms": busy_ms}
    print(f"  per-clip ms (model, host<->device copies included): "
          f"{', '.join(f'{x:.2f}' for x in clip_ms)}; median {timing['clip_ms']:.2f}")
    print(f"  forward only, clip on the card (CUDA events, median of 10): {forward_ms:.2f} ms")
    print(f"  two videos ({sum(VIDEO_FRAMES)} frames) end to end incl. tracking and masks: {wall:.2f} s; "
          f"{len(entries)} results.json entries")
    print("[phase 3] main path ran through every kernel; outputs finite; entries well-formed")
    return model, runner, records[0], launches, timing


# ---------------------------------------------------------------- phase 4
def phase_numerics(model, runner, record):
    import torch

    from vnext_tpu_torch.models.idol import build_idol_model

    frames, size = runner._prepare_frames({**record, "file_names": record["file_names"][:1]})
    cpu_model = build_idol_model(device="cpu", dtype=torch.float32, seed=1)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})

    def run(m, device):
        x = torch.from_numpy(frames).to(device).float()
        x = (x - runner.pixel_mean.to(device)) / runner.pixel_std.to(device)
        sizes = torch.tensor([size], dtype=torch.int32, device=device)
        with torch.inference_mode():
            return {k: v.float().cpu() for k, v in m.inference(x, sizes).items()}

    card = run(model, model.backbone.conv1.weight.device)
    t0 = time.perf_counter()
    ref = run(cpu_model, "cpu")
    print(f"  CPU f32 reference forward: {time.perf_counter() - t0:.1f} s")

    reason = ("bf16 keeps 8 significant bits (2^-9 relative per rounding) and the path rounds "
              "~100 times in sequence (53 convolutions, 12 transformer layers, heads), so errors "
              "that add like a random walk reach ~2%; 5% leaves headroom")

    def rel(name, a, b, tol):
        err = float((a - b).norm() / b.norm().clamp_min(1e-30))
        print(f"  {name}: relative L2 error {err:.4g} tolerance {tol}: {reason}")
        require(err <= tol, f"{name}: relative error {err} above {tol}")

    box_err = float((card["pred_boxes"] - ref["pred_boxes"]).abs().max())
    print(f"  pred_boxes: max_abs_err {box_err:.4g} tolerance 0.05: boxes are sigmoids in [0, 1] with "
          "slope <= 1/4, so a ~2% error in the refinement logits moves them by well under 0.05")
    require(box_err <= 0.05, f"pred_boxes error {box_err}")
    top = ref["pred_logits"][0].max(-1).values.topk(10).indices
    rel("pred_logits (top-10 queries)", card["pred_logits"][0, top], ref["pred_logits"][0, top], 0.05)
    rel("pred_masks", card["pred_masks"], ref["pred_masks"], 0.05)
    rel("pred_inst_embed", card["pred_inst_embed"], ref["pred_inst_embed"], 0.05)
    print("[phase 4] card (kernels, bf16) agrees with CPU (plain, f32) on frame 0")



# ---------------------------------------------------------------- phase 2b
def phase_train_kernels(dev):
    """K4 and K5 at the train step's shapes (4 frames at 512x640: Q = S = 6800 in
    the encoder, Q = 300 in the decoder), and K2's forward and backward."""
    import torch

    from vnext_tpu_torch.ops import ms_deform_attn as msda
    from vnext_tpu_torch.ops import stem_conv as stem

    rng = np.random.RandomState(1)
    bf16 = torch.bfloat16
    b, m, d, l, p = TRAIN_CLIPS, 8, 32, 4, 4
    s = sum(h * w for h, w in TRAIN_LEVELS)
    wh = np.asarray([[w, h] for h, w in TRAIN_LEVELS], np.float64)            # [L, 2]

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)

    # value rows of padding are zero (the last two columns and the bottom row of
    # every level, as a frame smaller than 512x640 pads)
    value = rng.randn(b, s, m, d)
    start = 0
    for h, w in TRAIN_LEVELS:
        grid = np.arange(h * w).reshape(h, w)
        value[:, start + np.concatenate([grid[:, -2:].ravel(), grid[-1]])] = 0.0
        start += h * w
    value = t(value, bf16)

    def locations(q):
        """Normalized locations [B, q, M, L, P, 2]: a quarter exactly on pixel
        centres ((k + 0.5) / w), 2% far outside every level, the rest uniform
        over the level and a little beyond."""
        loc = rng.rand(b, q, m, l, p, 2) * 1.2 - 0.1
        k = rng.randint(0, 10 ** 6, size=loc.shape) % wh[None, None, None, :, None, :].astype(int)
        centre = rng.rand(b, q, m, l, p) < 0.25
        loc[centre] = ((k + 0.5) / wh[None, None, None, :, None, :])[centre]
        far = rng.rand(b, q, m, l, p) < 0.02
        loc[far] = rng.choice([-4.0, 5.0], size=(int(far.sum()), 2))
        return t(loc)

    def attention(q):
        logits = torch.from_numpy(rng.randn(b, q, m, l * p).astype(np.float32) * 2.0).to(dev)
        return torch.softmax(logits, -1).to(bf16).view(b, q, m, l, p).contiguous()

    results = {}
    for form, q in (("encoder", s), ("decoder", 300)):
        loc, attn = locations(q), attention(q)
        grad = t(rng.randn(b, q, m * d), bf16)
        pix = loc * torch.tensor(wh, dtype=torch.float32, device=dev)[:, None, :] - 0.5
        on_pixel = int((pix == torch.floor(pix)).all(-1).sum())
        with torch.no_grad():
            got = msda.ms_deform_attn_standard(value, TRAIN_LEVELS, loc, attn, "pallas_v9")
        want = msda.ms_deform_attn_core_plain(value, TRAIN_LEVELS, loc, attn)
        torch.cuda.synchronize()
        err = compare(f"K4 ms_deform_attn_v9_fwd ({form}, B={b}, Q={q}; {on_pixel} samples on pixel centres)",
                      got, want, BF16_ULP * float(want.float().abs().max()),
                      "one bf16 ulp at the largest output: both sum the same bf16 inputs in f32 and "
                      "round once to bf16, in different orders")
        with torch.no_grad():
            ms = time_ms(lambda: msda.ms_deform_attn_standard(value, TRAIN_LEVELS, loc, attn, "pallas_v9"))
        plain_ms = time_ms(lambda: msda.ms_deform_attn_core_plain(value, TRAIN_LEVELS, loc, attn))
        n_fwd = samples_in_range(pix, TRAIN_LEVELS, strict=True)
        fwd_bound = bound_ms(nbytes(value, loc, attn, got), 10.0 * n_fwd * d, "f32")
        print(f"  K4 ({form}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {fwd_bound[0]:.4f} ms "
              f"by {fwd_bound[1]}; no single library call computes MSDA; {gathered(pix, TRAIN_LEVELS, ms)}")
        results[f"fwd_{form}"] = kernel_entry(err, ms, plain_ms, fwd_bound)

        dv, dl, da = msda.ms_deform_attn_v9_backward(value, TRAIN_LEVELS, loc, attn, grad)
        wv, wl, wa = msda.ms_deform_attn_grad_plain(value, TRAIN_LEVELS, loc, attn, grad)
        # each element's sum of |terms|: dvalue's terms attn * w_corner * g and
        # dattn's g * w_corner * v have their only signed factors in g and v
        sv, _, sa = msda.ms_deform_attn_grad_plain(value.abs(), TRAIN_LEVELS, loc, attn, grad.abs())
        torch.cuda.synchronize()
        require(dv.dtype == value.dtype and dl.dtype == loc.dtype and da.dtype == attn.dtype,
                "K5 returns each gradient in its input's dtype")
        # the kernel's dvalue atomics sum in an order that changes from run to run
        err_v = compare_each(f"K5 dvalue ({form})", dv, wv, sv)
        err_a = compare_each(f"K5 dattn ({form})", da, wa, sa)
        err_l = compare(f"K5 dloc ({form})", dl, wl, 1e-5 * float(wl.abs().max()),
                        "1e-5 of the largest element: f32 sums of the same ~128 products "
                        "(w_l * attn * g * corner differences) in another order; f32 "
                        "rounding puts that near 1e-7")
        ms = time_ms(lambda: msda.ms_deform_attn_v9_backward(value, TRAIN_LEVELS, loc, attn, grad))
        plain_ms = time_ms(lambda: msda.ms_deform_attn_grad_plain(value, TRAIN_LEVELS, loc, attn, grad))
        # ~30 f32 operations per (sample with a corner inside, channel): the
        # bilinear sample, both corner differences, three products with the
        # cotangent and their reductions, four scaled value-gradient adds
        n_bwd = samples_in_range(pix, TRAIN_LEVELS, strict=False)
        bwd_bound = bound_ms(nbytes(value, loc, attn, grad, dv, dl, da), 30.0 * n_bwd * d, "f32")
        # the value gradient's reductions: one f32 head row (128 B) per in-range corner
        red_gb = corners_in_range(pix, TRAIN_LEVELS, strict=False) * 128 / 1e9
        issued, distinct = backward_reductions(pix, TRAIN_LEVELS)
        print(f"  K5 ({form}) kernel {ms:.4f} ms (with the f32 scratch's zeroing and cast), "
              f"plain {plain_ms:.4f} ms (autograd of the plain version), bound {bwd_bound[0]:.4f} ms "
              f"by {bwd_bound[1]}; no single library call computes MSDA's backward; dvalue reductions "
              f"{red_gb:.4f} GB (in-range corners x 128 B) at {red_gb / (ms * 1e-3) / 1e3:.3f} TB/s; "
              f"{issued} of non-zero weight, which merging a head's repeats within a level would cut "
              f"to {distinct} ({1 - distinct / max(issued, 1):.2%} fewer)")
        results[f"bwd_{form}"] = kernel_entry(max(err_v, err_a, err_l), ms, plain_ms, bwd_bound)

        # the selector's v6 route (cfg.TPU.MSDA_IMPL "pallas"): its backward is K5
        # too, on the same inputs and held by the same rules
        dv, dl, da = msda.ms_deform_attn_v9_backward(value, TRAIN_LEVELS, loc, attn, grad, "pallas")
        err_v = compare_each(f"K6 backward route, dvalue ({form})", dv, wv, sv)
        err_a = compare_each(f"K6 backward route, dattn ({form})", da, wa, sa)
        err_l = compare(f"K6 backward route, dloc ({form})", dl, wl, 1e-5 * float(wl.abs().max()),
                        "as K5's dloc")
        ms6 = time_ms(lambda: msda.ms_deform_attn_v9_backward(value, TRAIN_LEVELS, loc, attn, grad, "pallas"))
        print(f"  K6 backward route ({form}) {ms6:.4f} ms (K5 through impl='pallas'), plain {plain_ms:.4f} ms")
        results[f"bwd6_{form}"] = kernel_entry(max(err_v, err_a, err_l), ms6, plain_ms, bwd_bound)

    # K2's forward at the train step's shape
    x = t(rng.randn(TRAIN_CLIPS, *TRAIN_HW, 3))
    k = t(rng.randn(7, 7, 3, 64) * 0.1)
    scale, bias = t(rng.rand(64) + 0.5), t(rng.randn(64) * 0.1)
    with torch.no_grad():
        got = stem.stem_conv7x7s2_bn_relu(x, k, scale, bias)
        want = stem.stem_conv_plain(x, k, scale, bias)
        torch.cuda.synchronize()
        err = compare(f"K2 stem_conv [{TRAIN_CLIPS},{TRAIN_HW[0]},{TRAIN_HW[1]},3]", got, want,
                      BF16_ULP * float(want.float().abs().max()),
                      "one bf16 ulp at the largest output: both sum exact products of bf16-rounded "
                      "operands in f32 and round once to bf16, in different orders")
        plain_ms = time_ms(lambda: stem.stem_conv_plain(x, k, scale, bias))
        ms = time_ms(lambda: stem.stem_conv7x7s2_bn_relu(x, k, scale, bias))
        xb = x.to(bf16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        kb = k.to(bf16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        library_ms = time_ms(lambda: torch.nn.functional.conv2d(xb, kb, stride=2, padding=3))
    bound = bound_ms(nbytes(x, k, scale, bias, got), 2.0 * got.numel() * 7 * 7 * 3, "bf16")
    print(f"  K2 (train shape) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN bf16 conv2d "
          f"{library_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]}")
    results["stem_train"] = kernel_entry(err, ms, plain_ms, bound, library_ms)

    # K2's backward: the autograd of the f32 linearization point, against the
    # autograd of the plain version. The plain version rounds the input to bf16
    # before its convolution and the linearization point (as JAX's) does not, so
    # both get an input that bf16 holds exactly: then they linearize at the same
    # point (a ReLU mask that differs on ~0.1% of outputs would otherwise move the
    # random-sign sums by ~sqrt(1e-3) = 3%)
    x = t(rng.randn(2, *TRAIN_HW, 3), bf16).float()
    args = [t(rng.randn(7, 7, 3, 64) * 0.1), t(rng.rand(64) + 0.5), t(rng.randn(64) * 0.1)]
    g = t(rng.randn(2, TRAIN_HW[0] // 2, TRAIN_HW[1] // 2, 64), bf16)
    leaves = [a.clone().requires_grad_() for a in args]
    stem.stem_conv7x7s2_bn_relu(x, *leaves).backward(g)
    plain = [a.clone().requires_grad_() for a in args]
    stem.stem_conv_plain(x, *plain).backward(g)
    for name, a, w in zip(("kernel", "scale", "bias"), leaves, plain):
        err = float((a.grad - w.grad).norm() / w.grad.norm())
        print(f"  K2 backward d{name}: relative L2 {err:.3g} tolerance 0.001: the same f32 products "
              "summed in other orders, and dkernel rounded to bf16 on both sides")
        require(err <= 1e-3, f"K2 backward d{name}: relative error {err}")
    print("[phase 2b] K4, K5 (and the v6 route's backward) and K2 agree with their plain versions at "
          "train-step shapes; K2 has a backward")
    return results


# ---------------------------------------------------------------- phase 5
def synthetic_batch(rng, n_clips=TRAIN_CLIPS):
    """A collated loader batch (``batch_to_model_inputs``'s format): key and
    reference frames [B, 512, 640, 3] uint8 with coloured rectangles, and up to
    48 instances per clip with labels, cxcywh boxes, stride-4 masks and ids; the
    reference frame moves each box a little and drops a few instances."""
    h, w = TRAIN_HW
    batch = {}
    n_inst = rng.randint(8, MAX_INSTS + 1, size=n_clips)
    centre = rng.rand(n_clips, MAX_INSTS, 2) * 0.7 + 0.15
    extent = rng.rand(n_clips, MAX_INSTS, 2) * 0.25 + 0.05
    labels = rng.randint(0, 40, size=(n_clips, MAX_INSTS)).astype(np.int32)
    for prefix in ("key", "ref"):
        c = centre + (rng.randn(*centre.shape) * 0.01 if prefix == "ref" else 0.0)
        valid = np.arange(MAX_INSTS)[None] < n_inst[:, None]
        if prefix == "ref":
            valid &= rng.rand(n_clips, MAX_INSTS) > 0.1
        images = rng.randint(0, 50, (n_clips, h, w, 3)).astype(np.uint8)
        masks = np.zeros((n_clips, MAX_INSTS, h // 4, w // 4), bool)
        for i in range(n_clips):
            for j in np.flatnonzero(valid[i]):
                x0, x1 = ((c[i, j, 0] + np.array([-0.5, 0.5]) * extent[i, j, 0]) * w).clip(0, w).astype(int)
                y0, y1 = ((c[i, j, 1] + np.array([-0.5, 0.5]) * extent[i, j, 1]) * h).clip(0, h).astype(int)
                images[i, y0:y1, x0:x1] = rng.randint(0, 256, 3)
                masks[i, j, y0 // 4:y1 // 4 + 1, x0 // 4:x1 // 4 + 1] = True
        batch[f"{prefix}_image"] = images
        batch[f"{prefix}_size"] = np.asarray([[h, w]] * n_clips, np.int32)
        batch[f"{prefix}_labels"] = labels
        batch[f"{prefix}_boxes"] = np.concatenate([c, extent], -1).astype(np.float32)
        batch[f"{prefix}_masks_s4"] = masks
        batch[f"{prefix}_valid"] = valid
        batch[f"{prefix}_inst_id"] = np.where(valid, np.arange(MAX_INSTS)[None], -1).astype(np.int32)
    return batch


def phase_train(dev, kernels):
    import torch

    from vnext_tpu_torch.engine.hooks import (HookBase, IterationTimer, LRTracker,
                                              PeriodicCheckpointer, PeriodicWriter)
    from vnext_tpu_torch.engine.train_step import TrainState, dropout_generator, make_train_step
    from vnext_tpu_torch.engine.trainer import PIXEL_MEAN, PIXEL_STD, VISTrainer, batch_to_model_inputs
    from vnext_tpu_torch.models.criterion import default_weight_dict
    from vnext_tpu_torch.models.idol import build_idol_model
    from vnext_tpu_torch.solver import build as solver
    from vnext_tpu_torch.utils.events import CommonMetricPrinter, JSONWriter

    cfg = SimpleNamespace(SOLVER=SOLVER)
    model = build_idol_model(device=dev, seed=0)
    print(f"  IDOL-R50 for training: dtype {model.dtype}, dropout 0.1, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters")
    optimizer = solver.build_optimizer(cfg, model)
    scheduler = solver.build_lr_scheduler(cfg, optimizer)
    state = TrainState.create(model, optimizer, scheduler)
    clip = solver.build_grad_clip(cfg)
    step_fn = make_train_step(model, optimizer, default_weight_dict(dec_layers=model.dec_layers), clip)
    batches = [synthetic_batch(np.random.RandomState(100 + i)) for i in range(TRAIN_STEPS)]
    print(f"  batches: {TRAIN_CLIPS} clips x (key + ref) at {TRAIN_HW[0]}x{TRAIN_HW[1]}, instances per clip "
          f"{[int(v.sum()) for v in batches[0]['key_valid']]} (first batch)")

    step_ms = []

    class SyncTimer(HookBase):
        """Wall time of each step, the card synchronized on both sides."""

        def before_step(self):
            torch.cuda.synchronize()
            self._t = time.perf_counter()

        def after_step(self):
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - self._t) * 1e3)

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = VISTrainer(step_fn, state, iter(batches), dev)
        trainer.register_hooks([
            SyncTimer(), IterationTimer(warmup_iter=1), LRTracker(solver.build_lr_schedule(cfg)),
            PeriodicCheckpointer(out_dir, period=TRAIN_STEPS),
            PeriodicWriter([JSONWriter(f"{out_dir}/metrics.json"), CommonMetricPrinter(TRAIN_STEPS)],
                           period=1),
        ])
        for kern in kernels.values():
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        trainer.train(0, TRAIN_STEPS)
        torch.cuda.synchronize()
        launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        with open(f"{out_dir}/metrics.json") as f:
            written = [json.loads(line) for line in f]
        saved = sorted(p.name for p in Path(out_dir).glob("*.pth"))

    expected = {"ms_deform_attn_v9_fwd": 24 * TRAIN_STEPS, "ms_deform_attn_v9_bwd": 24 * TRAIN_STEPS,
                "stem_conv": 2 * TRAIN_STEPS}
    print(f"  launches over {TRAIN_STEPS} steps: {launches} (expected {expected}: per step 12 MSDA "
          "layers x 2 frames forward, each with a backward since loss_reid reaches the reference "
          "frame's graph, and one stem per frame)")
    require(launches == expected, f"launch counts {launches} != {expected}")

    hist = trainer.storage.histories()
    loss_keys = sorted(k for k in hist if k.startswith("loss_"))
    # class, L1, GIoU, mask and dice losses per decoder layer, and the two ReID losses
    require(len(loss_keys) == 5 * model.dec_layers + 2, f"loss keys {loss_keys}")
    for k in loss_keys + ["total_loss"]:
        require(hist[k].count() == TRAIN_STEPS and np.isfinite(hist[k].values()).all(),
                f"{k}: {hist[k].values()}")
    # metrics reach the storage one step late: iterations 1 .. N of metrics.json
    # hold steps 0 .. N-1
    require([w["iteration"] for w in written if "total_loss" in w] == list(range(1, TRAIN_STEPS + 1)),
            f"metrics.json: {written}")
    require(saved == [f"model_{TRAIN_STEPS - 1:07d}.pth"], f"checkpoints {saved}")
    changed, frozen_moved, frozen = [], [], 0
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        if solver.is_frozen(n):
            frozen += 1
            if not same:
                frozen_moved.append(n)
        elif same:
            changed.append(n)
    require(not changed, f"trainable parameters that did not change: {changed[:10]}")
    require(not frozen_moved, f"frozen parameters that moved: {frozen_moved[:10]}")
    losses_by_step = ", ".join(f"{v:.4f}" for v in hist["total_loss"].values())
    norms_by_step = ", ".join(f"{v:.1f}" for v in hist["grad_norm"].values())
    print(f"  total_loss by step: {losses_by_step}; gradient norm {norms_by_step} (clipped to 0.01)")
    print(f"  every loss finite; {len(before) - frozen} trainable parameters changed, {frozen} frozen "
          f"ones bit-equal; metrics.json and {saved[0]} written")
    del before

    # the step's parts, synchronized: forward (with matching and losses), backward, clip + update
    inputs = batch_to_model_inputs(batches[0], PIXEL_MEAN, PIXEL_STD, dev)
    params = list(model.parameters())
    weights = default_weight_dict(dec_layers=model.dec_layers)
    parts = {"forward": [], "backward": [], "update": []}
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = model(*inputs, generator=dropout_generator(0, 100 + i, dev))
        total_loss = sum(losses[k] * weights[k] for k in losses if k in weights)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        total_loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        clip(params)
        optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(v * 1e3)
    split = {k: statistics.median(v) for k, v in parts.items()}

    # device time by kernel over two steps
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(2):
            losses = model(*inputs, generator=dropout_generator(0, 200 + i, dev))
            total_loss = sum(losses[k] * weights[k] for k in losses if k in weights)
            model.zero_grad(set_to_none=True)
            total_loss.backward()
            clip(params)
            optimizer.step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / 2
    from torch.autograd import DeviceType

    # the kernels themselves: operator rows carry their kernels' device time too,
    # and annotated regions (the optimizer's step) span kernels listed on their own
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3 / 2
    events.sort(key=lambda e: -e.self_device_time_total)
    print(f"  torch.profiler over 2 steps: device busy {device_ms:.1f} ms per step of {prof_wall:.1f} ms "
          f"wall under the profiler ({device_ms / prof_wall:.1%}); top kernels, ms per step:")
    print_kernel_rows(events, 2, 14)

    timed = step_ms[1:]
    result = {"step_ms": statistics.median(timed), "step_ms_all": step_ms, "forward_ms": split["forward"],
              "backward_ms": split["backward"], "update_ms": split["update"],
              "peak_memory_gb": peak_gb, "device_busy_ms": device_ms, "profiled_step_ms": prof_wall}
    print(f"  step ms (synchronized wall clock; the first is the warm-up): "
          f"{', '.join(f'{v:.1f}' for v in step_ms)}; median of the timed {result['step_ms']:.1f}")
    print(f"  split (median of 3): forward {split['forward']:.1f} ms, backward {split['backward']:.1f} ms, "
          f"clip + AdamW {split['update']:.1f} ms; peak memory {peak_gb:.2f} GiB")
    print("[phase 5] train path ran through K4 / K5 / K2; losses finite; trainable moved, frozen stayed")
    return launches, result


# ---------------------------------------------------------------- phase 6
GROUPS = (
    ("backbone", ("backbone.",)),
    ("input projections", ("input_proj_",)),
    ("encoder", ("transformer.encoder_", "transformer.level_embed")),
    ("decoder", ("transformer.decoder_", "transformer.reference_points", "transformer.bbox_embed_",
                 "query_embed")),
    ("heads", ("class_embed_",)),
)


PROJECTED = ("logits", "boxes", "hs")      # the last decoder layer's outputs phase 6 projects


@contextlib.contextmanager
def plain_on_card(names):
    """Inside, each named kernel's wrapper runs its plain version on the card in
    place of the kernel ("K2": the stem's forward, "K4": the MSDA standard
    entry's forward): phase 6 attributes a move of the card's value with it."""
    from vnext_tpu_torch.ops import ms_deform_attn as msda
    from vnext_tpu_torch.ops import stem_conv as stem

    saved = [(stem, "_launch", stem._launch), (msda, "_launch_v9_fwd", msda._launch_v9_fwd)]
    if "K2" in names:
        stem._launch = stem.stem_conv_plain
    if "K4" in names:
        msda._launch_v9_fwd = lambda value, shapes, loc, attn, *counters: msda.ms_deform_attn_core_plain(
            value, shapes, loc, attn)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def phase_train_numerics(dev, swaps=()):
    """Phase 6. ``swaps`` (``--swap-plain``): after the checked run, the card's
    forward again with each named kernel's plain version on the card, reported
    beside it and not checked."""
    import torch

    from vnext_tpu_torch.engine.trainer import PIXEL_MEAN, PIXEL_STD, batch_to_model_inputs
    from vnext_tpu_torch.models.idol import build_idol_model

    card = build_idol_model(device=dev, seed=3, dropout=0.0).train()
    cpu = build_idol_model(device="cpu", dtype=torch.float32, seed=4, dropout=0.0).train()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = synthetic_batch(np.random.RandomState(7), n_clips=1)
    rng = np.random.RandomState(8)
    n_q, n_cls, hid = card.query_embed.shape[0], card.num_classes, card.hidden_dim
    proj = [rng.randn(2, n_q, k).astype(np.float32) for k in (n_cls, 4, hid)]

    def run(model, device):
        key, key_size, ref, ref_size, *_ = batch_to_model_inputs(batch, PIXEL_MEAN, PIXEL_STD, device)
        x, sizes = torch.cat([key, ref]), torch.cat([key_size, ref_size])
        out = model.forward_single(x, sizes)
        r = [torch.from_numpy(a).to(device) for a in proj]
        outs = [out[k][-1].float() for k in PROJECTED]
        value = sum((o * w).sum() for o, w in zip(outs, r))
        model.zero_grad(set_to_none=True)
        value.backward()
        grads = {}
        for group, prefixes in GROUPS:
            gs = [p.grad.detach().float().cpu().reshape(-1) for n, p in model.named_parameters()
                  if n.startswith(prefixes) and p.grad is not None]
            grads[group] = torch.cat(gs)
        # the sum of the projection's |terms|: with |value| it says how much the signed sum cancels
        abs_terms = float(sum((o.detach() * w).abs().sum() for o, w in zip(outs, r)))
        return float(value.detach()), grads, [o.detach().cpu() for o in outs], abs_terms

    got, got_grads, got_outs, _ = run(card, dev)
    t0 = time.perf_counter()
    want, want_grads, want_outs, abs_terms = run(cpu, "cpu")
    print(f"  CPU f32 reference forward + backward: {time.perf_counter() - t0:.1f} s")
    reason = ("bf16 keeps 8 significant bits and the path rounds ~100 times in sequence forward "
              "(53 convolutions, 12 transformer layers, heads) and as many backward, so errors that "
              "add like a random walk reach a few percent")
    err = abs(got - want) / abs(want)

    def outputs_rel_l2(outs):
        return {k: float((a - b).norm() / b.norm()) for k, a, b in zip(PROJECTED, outs, want_outs)}

    def fmt(errs):
        return ", ".join(f"{k} {e:.4g}" for k, e in errs.items())

    print(f"  projection value: card {got:.6g} CPU {want:.6g}, |want| {abs(want):.6g}, sum of |terms| on the "
          f"CPU {abs_terms:.6g} ({abs(want) / abs_terms:.4g} of it survives the signed sum), relative error "
          f"{err:.4g} tolerance 0.05: {reason}")
    out_errs = outputs_rel_l2(got_outs)
    print(f"  the projected outputs, card vs CPU, relative L2: {fmt(out_errs)}; tolerance 0.05 each: {reason}")
    # the same weights with the sign of the CPU's outputs: every CPU term adds, none cancels,
    # so the relative error reads the outputs' own error and not the rounding order of a sum near 0
    unsigned = [torch.from_numpy(np.abs(a)) * torch.sign(o) for a, o in zip(proj, want_outs)]
    want_abs = float(sum((o * w).sum() for o, w in zip(want_outs, unsigned)))
    got_abs = float(sum((o * w).sum() for o, w in zip(got_outs, unsigned)))
    err_abs = abs(got_abs - want_abs) / abs(want_abs)
    print(f"  projection with the CPU outputs' signs (no term cancels): card {got_abs:.6g} CPU {want_abs:.6g}, "
          f"relative error {err_abs:.4g} tolerance 0.05: {reason}")
    for name in swaps:
        with plain_on_card((name,)):
            value, _, outs, _ = run(card, dev)
        print(f"  with {name}'s plain version on the card (not checked): card {value:.6g}, relative error "
              f"{abs(value - want) / abs(want):.4g}; outputs relative L2: {fmt(outputs_rel_l2(outs))}")
    require(err <= 0.05, f"projection value: relative error {err}")
    require(err_abs <= 0.05, f"projection with the CPU outputs' signs: relative error {err_abs}")
    for k, e in out_errs.items():
        require(e <= 0.05, f"projected output {k}: relative L2 {e}")
    for group, _ in GROUPS:
        a, b = got_grads[group], want_grads[group]
        e = float((a - b).norm() / b.norm().clamp_min(1e-30))
        print(f"  gradient of {group} ({b.numel()} values): relative L2 {e:.4g} tolerance 0.10: {reason}; "
              "gradients add the backward's roundings to the forward's")
        require(e <= 0.10, f"gradient of {group}: relative error {e}")
    print("[phase 6] card (kernels, bf16) agrees with CPU (plain, f32) on the train forward and its gradients")

# ---------------------------------------------------------------- phase 2c
ROUTES = ("pallas", "pallas_v7", "pallas_v8")      # cfg.TPU.MSDA_IMPL onto K4 / K5
ROUTE_KERNEL = {"pallas": "ms_deform_attn_v6_fwd", "pallas_v7": "ms_deform_attn_v7_fwd",
                "pallas_v8": "ms_deform_attn_v8_fwd"}


def phase_more_kernels(dev):
    """K4b at IDOL-R50's encoder shape, the selector's routes and K4 itself at the
    serving encoder and decoder shapes (the decoder's is SeqFormer's, nf = 10),
    and K9 at its own shape, each against its plain version."""
    import torch

    from vnext_tpu_torch.ops import ms_deform_attn as msda
    from vnext_tpu_torch.tools import exp_dynstore, kernel_ab

    rng = np.random.RandomState(2)
    bf16 = torch.bfloat16
    b, m, d, l, p = CLIP, 8, 32, 4, 4
    s = sum(h * w for h, w in LEVELS)
    wh = np.asarray([[w, h] for h, w in LEVELS], np.float64)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)

    value = rng.randn(b, s, m, d)
    start = 0
    for h, w in LEVELS:
        value[:, start + np.arange(h) * w + (w - 1)] = 0.0
        start += h * w
    value = t(value, bf16)

    def locations(ref_xy, q):
        """[b, q, M, L, P, 2]: around the references, a quarter exactly on pixel
        centres, 2% far outside every level."""
        loc = ref_xy[:, :, None, None, None, :] + rng.randn(b, q, m, l, p, 2) * 3.0 / wh[None, None, None, :, None, :]
        k = np.floor(loc * wh[None, None, None, :, None, :])
        centre = rng.rand(b, q, m, l, p) < 0.25
        loc[centre] = ((k + 0.5) / wh[None, None, None, :, None, :])[centre]
        far = rng.rand(b, q, m, l, p) < 0.02
        loc[far] = rng.choice([-4.0, 5.0], size=(int(far.sum()), 2))
        return t(loc)

    def attention(q):
        logits = torch.from_numpy(rng.randn(b, q, m, l * p).astype(np.float32) * 2.0).to(dev)
        return torch.softmax(logits, -1).to(bf16).view(b, q, m, l, p).contiguous()

    grid = np.concatenate([np.stack(np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h), -1).reshape(-1, 2)
                           for h, w in LEVELS])
    forms = {"enc": (locations(np.broadcast_to(grid, (b, s, 2)), s), attention(s)),
             "dec": (locations(rng.rand(b, 300, 2), 300), attention(300))}
    results = {}
    for form, (loc, attn) in forms.items():
        q = loc.shape[1]
        pix = loc * torch.tensor(wh, dtype=torch.float32, device=dev)[:, None, :] - 0.5
        want = msda.ms_deform_attn_core_plain(value, LEVELS, loc, attn)
        plain_ms = time_ms(lambda: msda.ms_deform_attn_core_plain(value, LEVELS, loc, attn))
        bound = bound_ms(nbytes(value, loc, attn, want), 10.0 * samples_in_range(pix, LEVELS, True) * d, "f32")
        tol = BF16_ULP * float(want.float().abs().max())
        for impl in ("auto",) + ROUTES:
            with torch.no_grad():
                got = msda.ms_deform_attn_standard(value, LEVELS, loc, attn, impl)
                torch.cuda.synchronize()
                err = compare(f"impl={impl} ({form}, B={b}, Q={q}, S={s})", got, want, tol,
                              "one bf16 ulp at the largest output: K4 and the plain version sum the same "
                              "bf16 inputs in f32 and round once, in other orders")
                ms = time_ms(lambda: msda.ms_deform_attn_standard(value, LEVELS, loc, attn, impl))
            print(f"  impl={impl} ({form}) K4 {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
                  f"by {bound[1]}; no single library call computes MSDA; {gathered(pix, LEVELS, ms)}")
            results[f"route_{impl}_{form}"] = kernel_entry(err, ms, plain_ms, bound)

    # K4b: the encoder's inputs in the channel-major layout
    loc, attn = forms["enc"]
    value_t = value.view(b, s, m * d).transpose(1, 2).contiguous()
    loc_cm = loc.permute(0, 2, 3, 4, 5, 1).contiguous()
    attn_cm = attn.permute(0, 2, 3, 4, 1).contiguous()
    with torch.no_grad():
        got = msda.ms_deform_attn_cm(value_t, LEVELS, loc_cm, attn_cm)
    want = msda.ms_deform_attn_cm_plain(value_t, LEVELS, loc_cm, attn_cm)
    torch.cuda.synchronize()
    err = compare(f"K4b ms_deform_attn_v9_cm (encoder, B={b}, Q=S={s})", got, want,
                  BF16_ULP * float(want.float().abs().max()),
                  "one bf16 ulp at the largest output: both sum the same bf16 inputs in f32 and round once")
    with torch.no_grad():
        ms = time_ms(lambda: msda.ms_deform_attn_cm(value_t, LEVELS, loc_cm, attn_cm))
        # the entry's two parts: the wrapper's transpose of the value to
        # token-major, and the kernel on a value already in that layout
        transpose_ms = time_ms(lambda: value_t.view(b, m, d, s).permute(0, 3, 1, 2).contiguous())
        kernel_ms = time_ms(lambda: msda._launch_cm(value, LEVELS, loc_cm, attn_cm))
    plain_ms = time_ms(lambda: msda.ms_deform_attn_cm_plain(value_t, LEVELS, loc_cm, attn_cm))
    pix = loc * torch.tensor(wh, dtype=torch.float32, device=dev)[:, None, :] - 0.5
    bound = bound_ms(nbytes(value_t, loc_cm, attn_cm, got), 10.0 * samples_in_range(pix, LEVELS, True) * d, "f32")
    print(f"  K4b entry {ms:.4f} ms: the value's transpose to token-major {transpose_ms:.4f} ms "
          f"({nbytes(value_t) / 1e6:.1f} MB each way), the kernel alone {kernel_ms:.4f} ms; plain "
          f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]}; no single library call computes MSDA; "
          f"{gathered(pix, LEVELS, kernel_ms)} (the kernel alone)")
    results["cm"] = kernel_entry(err, ms, plain_ms, bound)
    try:
        msda.ms_deform_attn_cm(value_t.clone().requires_grad_(), LEVELS, loc_cm, attn_cm)
    except RuntimeError as exc:
        require("inference-only" in str(exc), f"K4b: unexpected error {exc}")
        print(f"  K4b under autograd raises: {exc}")
    else:
        raise SmokeFailure("K4b ran under autograd instead of raising")

    # K9 at its own shape: the same f32 additions in the same order, so equal
    x, r = exp_dynstore.probe_inputs((0, 1, 2, 0))
    x, r = x.to(dev), r.to(dev)
    got = exp_dynstore.dynstore(x, r)
    want = exp_dynstore.dynstore_plain(x, r)
    err = compare(f"K9 dynstore {tuple(x.shape)}", got, want, 0.0,
                  "exact: the same f32 additions in the same order of steps")
    ms = time_ms(lambda: exp_dynstore.dynstore(x, r))
    # an empty kernel on K9's grid, block and shared memory: at this size the launch sets the time.
    # Both by events (one call per pair, the wrappers' host work included) and by the profiler
    # (the kernels' own device time, 20 calls)
    floor_ms = time_ms(lambda: exp_dynstore.empty_launch(x))
    dev_ms = kernel_ab.device_ms(lambda: exp_dynstore.dynstore(x, r), "dynstore_kernel")
    floor_dev_ms = kernel_ab.device_ms(lambda: exp_dynstore.empty_launch(x), "empty_kernel")
    plain_ms = time_ms(lambda: exp_dynstore.dynstore_plain(x, r))
    block = exp_dynstore.HB * exp_dynstore.D
    adds = 2.0 * x.shape[0] * exp_dynstore.T * block * x.shape[2]
    # the bytes the function needs: the x rows of the block, column 0 of r (the
    # offsets), the whole output once
    bound = bound_ms(nbytes(x[:, :block], r[:, :, 0], got), adds, "f32")
    print(f"  K9 kernel {ms:.4f} ms (device {dev_ms:.5f} ms) beside an empty kernel launched on its grid "
          f"{floor_ms:.4f} ms (device {floor_dev_ms:.5f} ms), the launch floor; plain {plain_ms:.4f} ms, bound "
          f"{bound[0]:.6f} ms by {bound[1]}; no single library call computes it")
    results["dynstore"] = {**kernel_entry(err, ms, plain_ms, bound), "device_ms": dev_ms,
                           "launch_floor_ms": floor_ms, "launch_floor_device_ms": floor_dev_ms}
    print("[phase 2c] K4b, K9 and every MSDA route agree with their plain versions")
    return results, (value_t, loc_cm, attn_cm)


def phase_entry_points(kernels, cm_inputs):
    """The two kernels no model path runs, through their own entry points as a
    user calls them: ``ms_deform_attn_cm`` (the channel-major MSDA entry) once at
    the encoder's shape, and the K9 probe's script."""
    import torch

    from vnext_tpu_torch.ops import ms_deform_attn as msda
    from vnext_tpu_torch.tools import exp_dynstore

    for kern in kernels.values():
        kern.launches = 0
    with torch.inference_mode():
        out = msda.ms_deform_attn_cm(*cm_inputs[:1], LEVELS, *cm_inputs[1:])
    require(bool(torch.isfinite(out.float()).all()), "ms_deform_attn_cm: non-finite output")
    require(exp_dynstore.main([]) == 0, "exp_dynstore probe failed")
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}
    expected = {"ms_deform_attn_v9_cm": 1, "dynstore": 1}
    print(f"  launches: {launches} (expected {expected})")
    require(launches == expected, f"launch counts {launches} != {expected}")
    print("[phase 2d] the channel-major MSDA entry and the K9 probe ran through their kernels")
    return launches


# ---------------------------------------------------------------- phase 7
def window_count(t: int, clip: int, stride: int) -> int:
    """Windows of the clip-matching path: ``stride * clip`` apart, the last flush with the end."""
    n, start = 1, 0
    while start + clip < t:
        start += stride * clip
        n += 1
    return n


def phase_seqformer(dev, kernels):
    import torch

    from vnext_tpu_torch.engine.seqformer_inference import SeqFormerVideoInference
    from vnext_tpu_torch.evaluation.ytvis_json import video_output_to_json
    from vnext_tpu_torch.models.seqformer import build_seqformer_model

    t0 = time.perf_counter()
    model = build_seqformer_model(device=dev, seed=0)
    print(f"  SeqFormer-R50 built in {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters, dtype {model.dtype}, "
          "seeded random weights (cocopretrain_seqformer_R50.pth is not in the repository)")
    videos = {vid: synthetic_video(vid, n) for vid, n in zip((1, 2), VIDEO_FRAMES)}
    store = {f"v{vid}/{i:05d}.jpg": fr for vid, frames in videos.items() for i, fr in enumerate(frames)}
    records = [
        {"video_id": vid, "height": VIDEO_HW[0], "width": VIDEO_HW[1], "length": len(frames),
         "file_names": [f"v{vid}/{i:05d}.jpg" for i in range(len(frames))]}
        for vid, frames in videos.items()
    ]
    whole = SeqFormerVideoInference(model, image_loader=store.__getitem__)
    matched = SeqFormerVideoInference(model, clip_matching=True, clip_length=SEQ_CLIP_LENGTH,
                                      clip_stride=1, image_loader=store.__getitem__)

    # Random weights score every query alike (~0.01), below the runner's 0.05
    # threshold. Raise the bias of class 0 so that a tenth of the queries of the
    # first 10 frames score 0.3 on it, so that instances, masks and entries are made.
    frames, size = whole._prepare_frames({**records[0], "file_names": records[0]["file_names"][:CLIP]})
    sizes = torch.tensor([size], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        x = ((torch.from_numpy(frames).to(dev).float() - whole.pixel_mean) / whole.pixel_std)[None]
        probe = model.inference(x, sizes)["pred_logits"][:, 0].float().cpu().numpy()
    shift = float(np.log(0.3 / 0.7) - np.quantile(probe, 0.9))
    with torch.no_grad():
        getattr(model, f"class_embed_{model.dec_layers - 1}").bias[0] += shift
    print(f"  class-0 bias raised by {shift:.3f} so that random weights make detections")

    clip_ms, finite = [], []
    for runner in (whole, matched):
        infer = runner.infer_topk

        def timed(frames, size, infer=infer):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cls, masks = infer(frames, size)
            clip_ms.append((len(frames), (time.perf_counter() - t1) * 1e3))
            finite.append(bool(np.isfinite(cls).all() and np.isfinite(masks).all()))
            return cls, masks

        runner.infer_topk = timed
    whole(records[1])                      # warm-up, not counted
    clip_ms.clear()
    finite.clear()

    for kern in kernels.values():
        kern.launches = 0
    t0 = time.perf_counter()
    results = [(rec, whole(rec)) for rec in records] + [(records[1], matched(records[1]))]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}

    n_clips = len(records) + window_count(VIDEO_FRAMES[1], SEQ_CLIP_LENGTH, 1)
    expected = {"ms_deform_attn_fwd": 6 * n_clips, "stem_conv": n_clips, "encoder_epilogue": 6 * n_clips,
                "ms_deform_attn_v9_fwd": 6 * n_clips}
    print(f"  launches over {n_clips} clips (2 whole videos, then the {VIDEO_FRAMES[1]}-frame one in windows "
          f"of {SEQ_CLIP_LENGTH}): {launches} (expected {expected}: per clip one stem, 6 encoder layers of "
          "K1's point form and K3, 6 decoder layers of K4 at batch nf, no K1 box form)")
    require(launches == expected, f"launch counts {launches} != {expected}")
    require(len(finite) == n_clips and all(finite), "non-finite SeqFormer outputs")

    entries = []
    for rec, out in results:
        js = video_output_to_json(out, rec["video_id"])
        for e in js:
            require(set(e) == {"video_id", "score", "category_id", "segmentations"}, f"entry keys {set(e)}")
            require(0.0 <= e["score"] <= 1.0 and 1 <= e["category_id"] <= 40, f"bad entry {e['score']}")
            require(len(e["segmentations"]) == rec["length"], "one segmentation per frame")
            require(all(sg["size"] == list(VIDEO_HW) and isinstance(sg["counts"], str)
                        for sg in e["segmentations"]), "RLE size / counts")
        entries += js
    require(len(entries) > 0, "no results.json entries")
    json.dumps(entries)

    with torch.inference_mode():
        forward_ms = time_ms(lambda: model.inference(x, sizes), reps=5, warmup=1)
    with torch.inference_mode():
        busy, prof_wall = profile_busy(lambda: model.inference(x, sizes),
                                       f"SeqFormer-R50 forward ({CLIP}-frame clip)", top=10)
    timing = {"clip_ms_by_frames": clip_ms, "forward_ms": forward_ms, "device_busy_ms": busy,
              "profiled_forward_ms": prof_wall}
    print(f"  per-clip ms through the runner (forward, top-10 on the card, their masks to the host), "
          f"as frames: ms: {', '.join(f'{n}: {v:.2f}' for n, v in clip_ms)}")
    print(f"  forward only, {CLIP}-frame clip on the card (CUDA events, median of 5): {forward_ms:.2f} ms")
    print(f"  2 videos whole + 1 clip-matched ({VIDEO_FRAMES[0] + 2 * VIDEO_FRAMES[1]} frames) end to end: "
          f"{wall:.2f} s; {len(entries)} results.json entries")
    print("[phase 7] SeqFormer-R50 ran through K1 / K2 / K3 / K4; outputs finite; entries well-formed")
    return model, whole, records[0], launches, timing


def phase_seqformer_numerics(model, runner, record):
    import torch

    from vnext_tpu_torch.models.seqformer import build_seqformer_model

    frames, size = runner._prepare_frames({**record, "file_names": record["file_names"][:2]})
    cpu_model = build_seqformer_model(device="cpu", dtype=torch.float32, seed=1)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})

    def run(m, device):
        x = torch.from_numpy(frames).to(device).float()
        x = (x - runner.pixel_mean.to(device)) / runner.pixel_std.to(device)
        sizes = torch.tensor([size], dtype=torch.int32, device=device)
        with torch.inference_mode():
            return {k: v.float().cpu() for k, v in m.inference(x[None], sizes).items()}

    card = run(model, next(model.parameters()).device)
    t0 = time.perf_counter()
    ref = run(cpu_model, "cpu")
    print(f"  CPU f32 reference forward (2 frames): {time.perf_counter() - t0:.1f} s")
    reason = ("bf16 keeps 8 significant bits and the path rounds ~100 times in sequence (53 convolutions, "
              "12 transformer layers, heads), so errors that add like a random walk reach ~2%")
    box_err = float((card["pred_boxes"] - ref["pred_boxes"]).abs().max())
    print(f"  pred_boxes: max_abs_err {box_err:.4g} tolerance 0.05: sigmoids with slope <= 1/4")
    require(box_err <= 0.05, f"pred_boxes error {box_err}")
    top = ref["pred_logits"].max(-1).values.topk(10).indices
    for name, a, b in (("pred_logits (top-10 queries)", card["pred_logits"][top], ref["pred_logits"][top]),
                       ("pred_masks", card["pred_masks"], ref["pred_masks"])):
        err = float((a - b).norm() / b.norm().clamp_min(1e-30))
        print(f"  {name}: relative L2 error {err:.4g} tolerance 0.05: {reason}")
        require(err <= 0.05, f"{name}: relative error {err}")
    print("[phase 8] SeqFormer card (kernels, bf16) agrees with CPU (plain, f32) on a 2-frame clip")


# ---------------------------------------------------------------- phase 9
def phase_selector_serve(dev, kernels, model, runner, record):
    """IDOL-R50 serving on one clip under each v6 / v7 / v8 route of
    ``cfg.TPU.MSDA_IMPL``, against the ``auto`` run on the same weights."""
    import torch

    from vnext_tpu_torch.models.idol import IDOL

    frames, size = runner._prepare_frames({**record, "file_names": record["file_names"][:CLIP]})
    with torch.inference_mode():
        x = (torch.from_numpy(frames).to(dev).float() - runner.pixel_mean) / runner.pixel_std
        sizes = torch.tensor([size] * CLIP, dtype=torch.int32, device=dev)
        auto = {k: v.float() for k, v in model.inference(x, sizes).items()}
    top = auto["pred_logits"].max(-1).values.topk(10, dim=1).indices                  # [T, 10]
    state = model.state_dict()
    per_impl, forward = {}, {}
    for impl in ROUTES:
        routed = IDOL(dtype=model.dtype, msda_impl=impl)
        routed.load_state_dict(state)
        routed = routed.to(dev).eval()
        for kern in kernels.values():
            kern.launches = 0
        with torch.inference_mode():
            out = {k: v.float() for k, v in routed.inference(x, sizes).items()}
        torch.cuda.synchronize()
        launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}
        expected = {ROUTE_KERNEL[impl]: 12, "ms_deform_attn_v9_fwd": 12, "stem_conv": 1, "encoder_epilogue": 6}
        print(f"  impl={impl}: launches per clip {launches} (expected {expected}: 6 encoder + 6 decoder "
              "layers through K4 on the route's counter, K1 not at all)")
        require(launches == expected, f"impl={impl}: launch counts {launches} != {expected}")
        for name in out:
            a, b = out[name], auto[name]
            if name == "pred_logits":
                a, b = a.gather(1, top[..., None].expand(-1, -1, a.shape[-1])), b.gather(
                    1, top[..., None].expand(-1, -1, b.shape[-1]))
            require(bool(torch.isfinite(a).all()), f"impl={impl}: non-finite {name}")
            err = float((a - b).norm() / b.norm().clamp_min(1e-30))
            print(f"    {name}{' (top-10 queries)' if name == 'pred_logits' else ''} vs auto: relative L2 "
                  f"{err:.4g} tolerance 0.02: the route rounds the softmaxed weights to bf16, K1 keeps them f32")
            require(err <= 0.02, f"impl={impl} {name}: relative error {err}")
        with torch.inference_mode():
            forward[impl] = time_ms(lambda: routed.inference(x, sizes), reps=3, warmup=1)
        print(f"    forward {forward[impl]:.2f} ms per clip (CUDA events, median of 3)")
        per_impl[impl] = launches
        del routed
    print("[phase 9] IDOL-R50 serving runs under every MSDA route, within 2% of auto")
    return per_impl, forward


# ---------------------------------------------------------------- phase 10
def phase_selector_train(dev, kernels):
    """Two IDOL-R50 train steps under cfg.TPU.MSDA_IMPL = "pallas" (the v6 route)."""
    import torch

    from vnext_tpu_torch.engine.train_step import TrainState, make_train_step
    from vnext_tpu_torch.engine.trainer import PIXEL_MEAN, PIXEL_STD, batch_to_model_inputs
    from vnext_tpu_torch.models.criterion import default_weight_dict
    from vnext_tpu_torch.models.idol import IDOL
    from vnext_tpu_torch.models.layers import init_weights
    from vnext_tpu_torch.solver import build as solver

    cfg = SimpleNamespace(SOLVER=SOLVER)
    model = IDOL(dtype=torch.bfloat16, msda_impl="pallas")
    init_weights(model, 5)
    model = model.to(dev)
    optimizer = solver.build_optimizer(cfg, model)
    state = TrainState.create(model, optimizer, solver.build_lr_scheduler(cfg, optimizer))
    step_fn = make_train_step(model, optimizer, default_weight_dict(dec_layers=model.dec_layers),
                              solver.build_grad_clip(cfg))
    inputs = [batch_to_model_inputs(synthetic_batch(np.random.RandomState(300 + i)), PIXEL_MEAN, PIXEL_STD, dev)
              for i in range(2)]
    for kern in kernels.values():
        kern.launches = 0
    totals = []
    for inp in inputs:
        state, metrics = step_fn(state, inp)
        require(all(bool(torch.isfinite(v).all()) for v in metrics.values()), "non-finite loss under pallas")
        totals.append(float(metrics["total_loss"]))
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}
    expected = {"ms_deform_attn_v6_fwd": 48, "ms_deform_attn_v6_bwd": 48, "ms_deform_attn_v9_fwd": 48,
                "ms_deform_attn_v9_bwd": 48, "stem_conv": 4}
    print(f"  launches over 2 steps: {launches} (expected {expected}: 24 MSDA forwards and backwards per "
          "step on the v6 route's counters beside K4's and K5's)")
    require(launches == expected, f"launch counts {launches} != {expected}")
    print(f"  total_loss by step {', '.join(f'{v:.4f}' for v in totals)}; every loss finite")
    print("[phase 10] the IDOL-R50 train step runs under impl='pallas' through K4 / K5")
    return launches


# ---------------------------------------------------------------- phase 11
MINVIS_WINDOW = 3             # MODEL.MASK_FORMER.TEST.WINDOW_SIZE of configs/minvis/ovis_r50.yaml
MINVIS_CLASSES = 25           # MODEL.MASK_FORMER.NUM_CLASSES of the same file
MINVIS_LEVELS = ((15, 27), (30, 54), (60, 108))   # its pixel decoder at 480x864, coarsest first


def minvis_kernel_checks(dev):
    """K1 and K3 against their plain versions at the shapes MinVIS-R50's pixel
    decoder gives them on a window of 3 frames: Q = S = 8505 grid references
    over 3 levels, coarsest first (L * P = 12, K1's generic prologue), and 3 x
    8505 tokens of 256 channels with FFN 1024."""
    import torch

    from vnext_tpu_torch.ops import ms_deform_attn as msda

    rng = np.random.RandomState(11)
    bf16 = torch.bfloat16
    b, m, d, l, p = MINVIS_WINDOW, 8, 32, len(MINVIS_LEVELS), 4
    s = sum(h * w for h, w in MINVIS_LEVELS)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)

    grid = np.concatenate([np.stack(np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h), -1)
                           .reshape(-1, 2) for h, w in MINVIS_LEVELS])
    off = rng.randn(b, s, m, l, p, 2) * 3.0
    far = rng.rand(b, s, m, l, p) < 0.02
    off[far] = rng.choice([-300.0, 300.0], size=(int(far.sum()), 2))
    args = (t(rng.randn(b, s, m, d), bf16), MINVIS_LEVELS, t(off, bf16),
            t(np.broadcast_to(grid[None, :, None, :], (b, s, l, 2))), t(rng.randn(b, s, m, l * p) * 2.0, bf16))
    got = msda.ms_deform_attn(*args)
    want = msda.ms_deform_attn_plain(*args)
    torch.cuda.synchronize()
    err = compare(f"K1 ms_deform_attn_fwd (MinVIS window, B={b}, Q=S={s}, 3 levels coarsest first)", got, want,
                  BF16_ULP * float(want.float().abs().max()),
                  "one bf16 ulp at the largest output: both sum the same bf16 inputs in f32 and round once")
    ms = time_ms(lambda: msda.ms_deform_attn(*args))
    plain_ms = time_ms(lambda: msda.ms_deform_attn_plain(*args))
    pix = msda.pixel_locations(MINVIS_LEVELS, args[2], args[3])
    bound = bound_ms(nbytes(*args[:1], *args[2:], got),
                     10.0 * samples_in_range(pix, MINVIS_LEVELS, strict=True) * d, "f32")
    print(f"  K1 (MinVIS window) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]}; "
          f"{gathered(pix, MINVIS_LEVELS, ms)}")
    results = {"msda_minvis": kernel_entry(err, ms, plain_ms, bound)}

    results["epilogue_minvis"], _ = epilogue_case(t, rng, b, s, f"(MinVIS window) [{b},{s},256]")
    return results


def phase_minvis(dev, kernels):
    """MinVIS-R50 serving: ``MinVISVideoInference`` on the two synthetic videos,
    then the forward alone at bench.py's ``bench_minvis`` shape (10 frames)."""
    import torch

    from vnext_tpu_torch.engine.minvis_inference import MinVISVideoInference
    from vnext_tpu_torch.evaluation.ytvis_json import video_output_to_json
    from vnext_tpu_torch.models.mask2former import build_maskformer_model

    kernel_checks = minvis_kernel_checks(dev)
    t0 = time.perf_counter()
    model = build_maskformer_model(device=dev, seed=0)
    print(f"  MinVIS-R50 (Mask2Former, {MINVIS_CLASSES} classes, 100 queries, 6 pixel-decoder + 9 decoder "
          f"layers) built in {time.perf_counter() - t0:.1f} s: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} "
          f"M parameters, dtype {model.dtype}, seeded random weights")
    videos = {vid: synthetic_video(vid, n) for vid, n in zip((1, 2), VIDEO_FRAMES)}
    store = {f"v{vid}/{i:05d}.jpg": fr for vid, frames in videos.items() for i, fr in enumerate(frames)}
    records = [
        {"video_id": vid, "height": VIDEO_HW[0], "width": VIDEO_HW[1], "length": len(frames),
         "file_names": [f"v{vid}/{i:05d}.jpg" for i in range(len(frames))]}
        for vid, frames in videos.items()
    ]
    runner = MinVISVideoInference(model, window_size=MINVIS_WINDOW, image_loader=store.__getitem__)
    infer, finite = runner.infer_clip, []

    def checked_clip(frames, size):
        out = infer(frames, size)
        finite.append(all(np.isfinite(v).all() for v in out.values()))
        return out

    runner.infer_clip = checked_clip
    runner(records[1])                      # warm-up, not counted
    finite.clear()

    for kern in kernels.values():
        kern.launches = 0
    video_ms, results = [], []
    for rec in records:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        results.append((rec, runner(rec)))
        torch.cuda.synchronize()
        video_ms.append((time.perf_counter() - t1) * 1e3)
    launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}
    n_windows = sum(-(-n // MINVIS_WINDOW) for n in VIDEO_FRAMES)
    expected = {"stem_conv": n_windows, "ms_deform_attn_fwd": 6 * n_windows, "encoder_epilogue": 6 * n_windows}
    print(f"  launches over {n_windows} windows of {MINVIS_WINDOW}: {launches} (expected {expected}: per window "
          "one stem and 6 pixel-decoder layers of K1's point form and K3; no K4 or K5)")
    require(launches == expected, f"launch counts {launches} != {expected}")
    require(len(finite) == n_windows and all(finite), "non-finite MinVIS outputs")

    entries = []
    for rec, out in results:
        js = video_output_to_json(out, rec["video_id"])
        require(len(js) == 10, f"{len(js)} entries: MinVIS keeps its top 10 (query, class) pairs")
        for e in js:
            require(set(e) == {"video_id", "score", "category_id", "segmentations"}, f"entry keys {set(e)}")
            require(0.0 <= e["score"] <= 1.0 and 1 <= e["category_id"] <= MINVIS_CLASSES, f"bad entry {e}")
            require(len(e["segmentations"]) == rec["length"], "one segmentation per frame")
            require(all(sg["size"] == list(VIDEO_HW) and isinstance(sg["counts"], str)
                        for sg in e["segmentations"]), "RLE size / counts")
        entries += js
    json.dumps(entries)

    # the forward alone at bench_minvis's shape: 10 frames at 480x864, already on the card
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(CLIP, HEIGHT, WIDTH, 3).astype(np.float32)).to(dev)
    with torch.inference_mode():
        forward_ms = time_ms(lambda: model.inference(x), reps=5, warmup=1)
        busy, prof_wall = profile_busy(lambda: model.inference(x), f"MinVIS-R50 forward ({CLIP} frames)", top=12)
    timing = {"video_ms": video_ms, "forward_ms": forward_ms, "device_busy_ms": busy,
              "profiled_forward_ms": prof_wall, "kernels": kernel_checks}
    print(f"  per-video ms through the runner ({', '.join(f'{n} frames' for n in VIDEO_FRAMES)}; windows of "
          f"{MINVIS_WINDOW}, f32 outputs to the host, matching, top 10, masks at 480x853): "
          f"{', '.join(f'{v:.1f}' for v in video_ms)}")
    print(f"  forward only, {CLIP} frames at {HEIGHT}x{WIDTH} on the card (CUDA events, median of 5): "
          f"{forward_ms:.2f} ms; {len(entries)} results.json entries")
    print("[phase 11] MinVIS-R50 ran through K2 / K1 / K3; outputs finite; entries well-formed")
    return model, runner, records[0], launches, timing


def phase_minvis_numerics(model, runner, record):
    """One frame at 480x864 through ``MaskFormer.forward_frames`` on the card
    (kernels, bf16) and on the CPU (plain versions, f32)."""
    import torch

    from vnext_tpu_torch.models.mask2former import build_maskformer_model

    frames, _ = runner._prepare_frames({**record, "file_names": record["file_names"][:1]})
    cpu_model = build_maskformer_model(device="cpu", dtype=torch.float32, seed=1)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})

    def run(m, device):
        x = (torch.from_numpy(frames).to(device).float() - runner.pixel_mean.to(device)) / runner.pixel_std.to(device)
        with torch.inference_mode():
            out = m.forward_frames(x)
        return ({"pred_logits": out["logits"][-1].float().cpu(), "pred_masks": out["masks"][-1].float().cpu(),
                 "pred_embds": out["embeds"].float().cpu()}, [a.cpu() for a in out["attn_masks"]])

    card, card_masks = run(model, next(model.parameters()).device)
    t0 = time.perf_counter()
    ref, ref_masks = run(cpu_model, "cpu")
    print(f"  CPU f32 reference forward (1 frame): {time.perf_counter() - t0:.1f} s")
    flips = [float((a != b).float().mean()) for a, b in zip(card_masks, ref_masks)]
    print("  attention-mask bits that differ, card vs CPU, by decoder layer (each layer's mask is the "
          "previous prediction's sigmoid < 0.5, a hard threshold; a flipped bit lets a query see a pixel, or "
          f"not): {', '.join(f'{f:.4%}' for f in flips)}")
    reason = ("bf16 keeps 8 significant bits and the path rounds ~100 times in sequence (53 convolutions, "
              "6 pixel-decoder and 9 decoder layers, heads), so errors that add like a random walk reach a few "
              "percent; the attention masks' flipped bits add to them")
    for name in ("pred_logits", "pred_embds", "pred_masks"):
        a, b = card[name], ref[name]
        err = float((a - b).norm() / b.norm().clamp_min(1e-30))
        print(f"  {name}: relative L2 error {err:.4g} tolerance 0.05: {reason}")
        require(err <= 0.05, f"{name}: relative error {err}")
    print("[phase 12] MinVIS card (kernels, bf16) agrees with CPU (plain, f32) on one frame")
    return flips


# ---------------------------------------------------------------- phase 13
INSTMOVE_BATCH, INSTMOVE_PAST, INSTMOVE_HW = 32, 4, (128, 128)   # bench.py's bench_instmove


def phase_instmove(dev, kernels, minvis_model, record):
    """InstMove at ``bench_instmove``'s shape (bf16, B = 32), card vs CPU at B =
    2 of those inputs, and the motion-fused MinVIS runner at 480x864, which
    must raise (its 120x216 masks are not multiples of 16)."""
    import torch

    from vnext_tpu_torch.engine.minvis_inference import MinVISVideoInference
    from vnext_tpu_torch.models.instmove import build_instmove_model, lstm_state_hw, motion_memory_hw

    model = build_instmove_model(device=dev, dtype=torch.bfloat16, seed=0)
    print(f"  InstMove (memory 100, 4 ConvLSTM layers of 128 channels, ResNet-50 image encoder) in "
          f"{model.dtype}: {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters, seeded random weights")
    rng = np.random.RandomState(0)
    h, w = INSTMOVE_HW
    masks = torch.from_numpy((rng.rand(INSTMOVE_BATCH, INSTMOVE_PAST, h, w, 1) > 0.7).astype(np.float32)).to(dev)
    image = torch.from_numpy(rng.randn(INSTMOVE_BATCH, h, w, 3).astype(np.float32)).to(dev)
    with torch.inference_mode():
        model(masks, image)                 # warm-up
        for kern in kernels.values():
            kern.launches = 0
        out = model(masks, image)
        torch.cuda.synchronize()
        launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}
        ms = time_ms(lambda: model(masks, image), reps=5, warmup=1)
    expected = {"stem_conv": 1}
    print(f"  launches per call: {launches} (expected {expected}: the image ResNet's stem)")
    require(launches == expected, f"launch counts {launches} != {expected}")
    require(out.shape == (INSTMOVE_BATCH, 1, h, w, 1) and bool(torch.isfinite(out.float()).all()),
            f"InstMove output {tuple(out.shape)} not finite or misshapen")
    print(f"  B={INSTMOVE_BATCH}, {INSTMOVE_PAST} past masks at {h}x{w}: {ms:.2f} ms per call (CUDA events, "
          f"median of 5), {INSTMOVE_BATCH / ms * 1e3:.1f} instance-clips/s")

    cpu = build_instmove_model(device="cpu", dtype=torch.float32, seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        got = model(masks[:2], image[:2]).float().cpu()
        t0 = time.perf_counter()
        want = cpu(masks[:2].cpu(), image[:2].cpu())
    err = float((got - want).norm() / want.norm())
    print(f"  card (bf16, K2) vs CPU (f32, plain) at B=2: relative L2 {err:.4g} tolerance 0.05 (CPU "
          f"{time.perf_counter() - t0:.1f} s): bf16 rounds ~50 times in sequence (the ResNet to res3, 4 ConvLSTM "
          "layers x 4 steps, the 3-D encoder and the decoder), errors adding like a random walk")
    require(err <= 0.05, f"InstMove card vs CPU: relative error {err}")

    # the motion-fused runner as tools/train_net_video.py runs it by default (480x864 frames, 120x216 masks)
    predictor = build_instmove_model(device=dev, seed=0)           # f32, as the JAX package builds it
    frames = {f"m/{i:05d}.jpg": fr for i, fr in enumerate(synthetic_video(3, INSTMOVE_PAST + 2))}
    motion_record = {"video_id": 3, "height": VIDEO_HW[0], "width": VIDEO_HW[1], "length": len(frames),
                     "file_names": sorted(frames)}
    runner = MinVISVideoInference(minvis_model, window_size=MINVIS_WINDOW, motion_predictor=predictor,
                                  image_loader=frames.__getitem__)
    th, tw = runner.target_size
    shapes = ["x".join(map(str, f(th // 4, tw // 4))) for f in (motion_memory_hw, lstm_state_hw)]
    try:
        runner(motion_record)
    except ValueError as exc:
        require("multiples of 16" in str(exc) and all(sh in str(exc) for sh in shapes),
                f"unexpected ValueError (expected the shapes {shapes}): {exc}")
        print(f"  the motion-fused runner at {th}x{tw} raises, as the JAX package fails there: {exc}")
    else:
        raise SmokeFailure("the motion-fused runner ran at 120x216 masks instead of raising")
    print("[phase 13] InstMove ran through K2; card agrees with CPU; the motion runner refuses 120x216 masks")
    return launches, {"ms_per_call": ms, "batch": INSTMOVE_BATCH, "card_vs_cpu_rel_l2": err}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke test of the port on one NVIDIA GPU; "
                                                 "with no argument, every phase.")
    parser.add_argument("--only", choices=("train_numerics",),
                        help="phase 1 and this phase alone (train_numerics: phase 6)")
    parser.add_argument("--tree", help="with --only: import vnext_tpu_torch from this checkout (an "
                                       "earlier commit's `git archive`) in place of the one beside this script")
    parser.add_argument("--swap-plain", action="append", default=[], choices=("K2", "K4"),
                        help="with --only train_numerics: also run the card's forward with this "
                             "kernel's plain version on the card (repeatable)")
    args = parser.parse_args(argv)
    if (args.tree or args.swap_plain) and not args.only:
        parser.error("--tree and --swap-plain go with --only")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    if args.only:
        smi = phase_card()
        phase_train_numerics(dev, args.swap_plain)
        print(smi)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0

    from vnext_tpu_torch.ops import encoder_epilogue, stem_conv
    from vnext_tpu_torch.ops import ms_deform_attn as msda
    from vnext_tpu_torch.tools import exp_dynstore

    logging.basicConfig(level=logging.INFO, stream=sys.stdout, format="  %(name)s: %(message)s")
    # every kernel's counter: each path zeroes them all before it runs and reads them all after
    kernels = {k.name: k for k in (msda.KERNEL, stem_conv.KERNEL, encoder_epilogue.KERNEL, msda.KERNEL_V9_FWD,
                                   msda.KERNEL_V9_BWD, msda.KERNEL_CM, msda.KERNEL_V6_FWD, msda.KERNEL_V6_BWD,
                                   msda.KERNEL_V7_FWD, msda.KERNEL_V8_FWD, exp_dynstore.KERNEL)}
    smi = phase_card()
    measured = phase_kernels(dev)
    measured.update(phase_train_kernels(dev))
    more, cm_inputs = phase_more_kernels(dev)
    measured.update(more)
    entry_launches = phase_entry_points(kernels, cm_inputs)
    del cm_inputs
    model, runner, record, serve_launches, timing = phase_main_path(dev, kernels)
    phase_numerics(model, runner, record)
    route_launches, route_forward_ms = phase_selector_serve(dev, kernels, model, runner, record)
    del model, runner
    torch.cuda.empty_cache()
    seq_model, seq_runner, seq_record, seq_launches, seq_timing = phase_seqformer(dev, kernels)
    phase_seqformer_numerics(seq_model, seq_runner, seq_record)
    del seq_model, seq_runner
    torch.cuda.empty_cache()
    train_launches, train_timing = phase_train(dev, kernels)
    phase_train_numerics(dev)
    route_train_launches = phase_selector_train(dev, kernels)
    torch.cuda.empty_cache()
    phase_seconds = {}
    t0 = time.perf_counter()
    mv_model, mv_runner, mv_record, minvis_launches, minvis_timing = phase_minvis(dev, kernels)
    phase_seconds["11"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    minvis_timing["attention_mask_bits_differing"] = phase_minvis_numerics(mv_model, mv_runner, mv_record)
    phase_seconds["12"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    instmove_launches, instmove_timing = phase_instmove(dev, kernels, mv_model, mv_record)
    phase_seconds["13"] = time.perf_counter() - t0
    print("  seconds by phase: " + ", ".join(f"{k}: {v:.1f}" for k, v in phase_seconds.items()))
    del mv_model, mv_runner

    print(json.dumps({
        "slice": timing, "seqformer": seq_timing, "train": train_timing, "minvis": minvis_timing,
        "instmove": instmove_timing, "phase_seconds": phase_seconds,
        "idol_forward_ms_by_impl": {"auto": timing["forward_ms"], **route_forward_ms},
        "msda_decoder_form": measured["dec"], "k4_decoder_form": measured["fwd_decoder"],
        "k5_decoder_form": measured["bwd_decoder"], "k6_backward_decoder_form": measured["bwd6_decoder"],
        "k2_serving": measured["stem"], "k4_serving": {f: measured[f"route_auto_{f}"] for f in ("enc", "dec")},
        "routes_serving": {impl: {f: measured[f"route_{impl}_{f}"] for f in ("enc", "dec")} for impl in ROUTES},
    }))
    paths = {"serve": serve_launches, "seqformer": seq_launches,
             **{f"serve_{impl}": route_launches[impl] for impl in ROUTES},
             "train": train_launches, "train_pallas": route_train_launches, "entry_points": entry_launches,
             "minvis": minvis_launches, "instmove": instmove_launches}
    rows = [  # (kernel, the path its launches are reported from, the measurement it is reported by)
        (msda.KERNEL, "serve", "enc"),
        (stem_conv.KERNEL, "train", "stem_train"),
        (encoder_epilogue.KERNEL, "serve", "epilogue"),
        (msda.KERNEL_V9_FWD, "train", "fwd_encoder"),
        (msda.KERNEL_V9_BWD, "train", "bwd_encoder"),
        (msda.KERNEL_CM, "entry_points", "cm"),
        (msda.KERNEL_V6_FWD, "serve_pallas", "route_pallas_enc"),
        (msda.KERNEL_V6_BWD, "train_pallas", "bwd6_encoder"),
        (msda.KERNEL_V7_FWD, "serve_pallas_v7", "route_pallas_v7_enc"),
        (msda.KERNEL_V8_FWD, "serve_pallas_v8", "route_pallas_v8_enc"),
        (exp_dynstore.KERNEL, "entry_points", "dynstore"),
    ]
    for kern, path, _ in rows:
        require(paths[path].get(kern.name, 0) > 0, f"{kern.name}: no launch on the {path} path")
    print(json.dumps({"kernels": [
        {"name": kern.name, "route": "cuda", "source": kern.source, "replaces": kern.replaces,
         "launches": paths[path][kern.name],
         "launches_by_path": {p: launches.get(kern.name, 0) for p, launches in paths.items()},
         **measured[key]}
        for kern, path, key in rows
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
