#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``vnext_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                          # every phase
    python3 chip_smoke.py --only train_numerics    # phases 1 and 6 alone
    python3 chip_smoke.py --only entry_point       # phases 1 and 17 alone
    python3 chip_smoke.py --only minvis_entry      # phases 1, 2b's new shapes and 18 alone
    python3 chip_smoke.py --only seqformer_train   # phases 1 and 19 alone
    python3 chip_smoke.py --only swin_train        # phases 1, 20 and 21 alone
    python3 chip_smoke.py --only instmove_train    # phase 1, K2 at InstMove's call and phase 22 alone
    python3 chip_smoke.py --only fused_tracker     # phases 1 and 23 alone
    python3 chip_smoke.py --only coco_pretrain     # phases 1 and 24 alone

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
   forward and backward at the train step's shapes; then K4 and K5 at
   MinVIS-R50's train shape (4 frames at 512x768, Q = S = 8064 over 3 levels
   coarsest first, L * P = 12) and at SeqFormer-R50's encoder and box-form
   decoder shapes (4 clips x 5 frames, Q = S = 6800 and Q = 300), and K2's
   forward and backward at both steps' frames. 2a also holds K2 at InstMove's
   call (bench.py's ``bench_instmove``: 32 frames at 128x128). 2c: K4 and the selector's routes
   ("pallas", "pallas_v7", "pallas_v8") at the serving encoder and decoder
   shapes (the decoder's is SeqFormer's), K4b (the channel-major entry) at the
   encoder's, and K9 at its own beside an empty kernel launched on its grid
   (the launch floor). 2d: the two kernels no model path runs, through their
   entry points: ``ms_deform_attn_cm`` once and the K9 probe.
Every model is built from its config file under ``configs/``, read by the
port's own reader (``vnext_tpu_torch.config``).

3. The serving path: IDOL-R50 (``configs/idol/ytvis19_r50.yaml``: 40 classes,
   300 queries, 6 + 6 layers, hidden 256, bf16, seeded random weights) through
   ``IDOLVideoInference`` on two
   synthetic videos of 20 and 13 frames at 480x853 (clips of 10 padded to
   480x864). The launch counters must read K1 / K2 / K3 = 12 / 1 / 6 per clip,
   all outputs must be finite and the ``results.json`` entries well-formed.
   Then the forward alone on a clip already on the card: its time (CUDA
   events), peak memory, the time inside the backbone (and inside its window
   attention, for Swin), and its device time by kernel (``torch.profiler``).
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
14. IDOL-Swin-L (``configs/idol/ytvis19_swinL.yaml``: Swin-L 192 wide, depths
    2 / 2 / 18 / 2, window 12, bf16, seeded random weights) as phase 3: K1 /
    K2 / K3 = 12 / 0 / 6 per clip (a patch embed, no stem), and the forward of
    a clip of 10 at 480x864 (``bench_swinl``'s shape) with its window
    attention's time; then frame 0 card vs CPU as phase 4.
15. SeqFormer-Swin-L (``configs/seqformer/swin_ytvis.yaml``) as phases 7 and 8:
    K1 / K2 / K3 / K4 = 6 / 0 / 6 / 6 per clip.
16. IDOL-R101 (``configs/idol/ytvis19_r101.yaml``): one clip (K1 / K2 / K3 =
    12 / 1 / 6), its forward's profile, frame 0 card vs CPU; then IDOL-Swin-L's
    seeded state written out under the reference's names (``module.``
    prefixed ``.pth``) and imported into a model of another seed
    (``checkpoint/torch_import.py``): a clean report, and outputs equal bit for
    bit to the seeded model's on a clip.
    The seconds of phases 11-16 are printed.
17. IDOL's entry point (``vnext_tpu_torch.tools.train_net.main``, in-process)
    on a synthetic YTVIS dataset written to a temporary directory (2 videos x
    20 frames at 480x853, PNG): ``--eval-only`` with
    ``configs/idol/ytvis19_r50.yaml`` at full width (its seeded model's
    class-0 bias raised as in phase 3, the counters zeroed after that probe):
    K1 / K2 / K3 = 48 / 4 / 24 over the 4 clips, ``results.json`` well-formed,
    the AP dict's values fractions in [0, 1] (NaN where an area bin holds no
    ground truth); the ground truth through ``YTVISEvaluator`` (its native C
    path) scores AP 1.0; training (4 clips a step, 4 steps, checkpoints every
    2) with K4 / K5 / K2 = 24 / 24 / 2 per step, finite losses,
    ``metrics.json`` and ``last_checkpoint``, and the evaluation after
    training on K1 / K2 / K3 and no K4; then ``--resume`` to 6 steps, which
    starts at iteration 4 at the schedule's rate with the saved model,
    optimizer and scheduler state bit for bit. It prints per-video ms
    through ``do_eval``, the evaluator's seconds, the step period through
    the entry point beside the time ``next(loader)`` blocked, and the
    checkpoint's save and load seconds and size. ``--only entry_point``
    runs phases 1 and 17 alone, and adds two measurements: the steady step
    period through the entry point over 20 steps with no checkpoint saved
    and no evaluation inside the window, with the live loader and on the same
    batches made beforehand, alternately, twice each; and a host profile
    (``cProfile``) of a second ``--eval-only`` run.

18. MinVIS-R50 through its entry point (``vnext_tpu_torch.tools.train_net_video.main``,
    in-process) at ``configs/minvis/ovis_r50.yaml``'s width (R50, hidden 256,
    100 queries, 6 + 9 layers, 12544 sampled points, bf16, seeded weights) on
    a synthetic dataset as phase 17's whose json lists OVIS's 25 categories:
    ``--eval-only`` in windows of 3 (K2 / K1 / K3 = 1 / 6 / 6 a window, 10
    entries a video, per-video ms, the evaluator's seconds), the ground truth
    through ``YTVISEvaluator`` at AP 1.0; 4 training steps of 2 clips (key +
    reference, one card's share of ``IMS_PER_BATCH`` 16 on 8 cards) at
    512x768 with checkpoints every 2 (K4 / K5 / K2 = 6 / 6 / 1 a step; the
    step period beside the time ``next(loader)`` blocked, the host time of
    the assignment, peak memory), ``--resume`` to 6 (state bit-equal to the
    file), and ``ovis_r50_motion.yaml``'s ``ValueError`` at 120x216 masks. Then
    one clip's train forward and backward card (bf16) vs CPU (f32) on point
    coordinates drawn once on the CPU: losses within 5%, gradients by group
    within 10%, at the card's own assignment and at the CPU's (how many
    assignments differ is printed).
19. SeqFormer-R50's clip-level train step (``configs/seqformer/ytvis19_r50.yaml``:
    hidden 256, 300 queries, 6 + 6 layers, bf16, dropout 0.1, seeded weights)
    through ``make_train_step`` on seeded synthetic ``ClipTargets`` (4 clips x
    5 frames at 512x640, up to 24 instances): 3 steps, K4 / K5 / K2 = 12 / 12
    / 1 a step, losses finite, frozen parameters bit-equal, and each
    trainable one reached by a gradient (a non-zero AdamW first moment), moved
    no further than AdamW's steps allow, and moved wherever the last update
    was 4 ulps of an element or more (the warm-up's first updates round away
    on larger elements); the step's
    forward / backward / update split beside the
    device's busy time, the assignment's host time and peak memory; one clip
    card vs CPU at dropout 0, as phase 18's.
20. IDOL-Swin-L training (``configs/idol/ytvis19_swinL.yaml``: Swin-L at its
    published drop-path 0.3, bf16, seeded weights): 3 steps of 4 clips (key +
    reference at 512x640) through ``make_train_step``, K4 / K5 = 24 / 24 a step,
    the update held landed as phase 19's, the step's split, busy share and
    peak memory; every Swin block's rate from the linspace table and, over the
    steps' draws, its kept share within 4 sigma of 1 - rate; two forwards from
    one (seed, step) draw the same masks. One clip card vs CPU at drop-path 0
    and dropout 0, the CPU's simOTA matching and ReID selection replayed on
    the card. Then ``train_net.main`` on a synthetic dataset (2 videos x 6
    frames): 2 steps with a checkpoint, ``--resume`` to 3, the restored state
    equal to the file bit for bit.
21. SeqFormer-Swin-L's train step (``configs/seqformer/swin_ytvis.yaml``) as
    phase 19, 4 clips x 5 frames at 512x640, K4 / K5 = 12 / 12 a step, with
    phase 20's drop-path checks; card vs CPU on one clip of 5 frames at
    384x480 (the CPU's f32 reference near a minute).
22. InstMove training through ``vnext_tpu_torch.tools.train_instmove.main``
    (``configs/minvis/ovis_r50_motion.yaml``, full width, f32, TF32 off) on a
    synthetic dataset of 2 videos x 20 frames: 20 steps of 16 sequences at
    192x192, no hand-written kernel (K2 runs in bf16 only), the step time,
    peak memory and loss curve, checkpoints and ``instmove_final``; the first
    step card vs CPU on the tool's own first batch.
23. IDOL-R50 with ``TPU.FUSED_TRACKER`` on the two videos: K1 / K2 / K3 = 12 /
    1 / 6 a clip, the on-device tracker's steps under the sync debug mode set
    to raise (no copy to the host inside a clip), its per-frame (query, track
    id) associations against the host tracker's on the same outputs (at
    capacities no frame fills, and at the defaults' 32 / 64 up to the first
    frame where they bind), the device kernels it launches a frame, and the
    time per video beside the host tracker's runner.
24. IDOL's COCO-pretrain stage through ``train_net.main`` with
    ``INPUT.COCO_PRETRAIN True`` at ``configs/idol/coco_pretrain/r50_coco_sequence.yaml``'s
    width (80 classes, 48 instances, 512x640, the yaml's resize, crop and
    flip) on a synthetic COCO set of 32 images at 480x640, 4 pseudo-clips a
    step, from a torchvision-form ``R-50.pkl`` written from a seeded
    ResNet-50: the backbone on the card equal to the file's after the load,
    K4 / K5 / K2 = 24 / 24 / 2 a step, 32 loss keys finite every step, the
    step period, the time ``next(loader)`` blocked and peak memory; a 2-step
    run resumed to 4 (the restored state equal to the file bit for bit, the
    resumed steps on the loader's first batches again, as in JAX) against the
    straight 4-step run (the difference printed); then
    ``swin_coco_sequence.yaml`` for 2 steps with seeded weights (K4 / K5 = 24
    / 24 a step) and its peak memory. The evaluation after training runs on a
    synthetic YTVIS set whose json lists 80 categories.

Then a JSON line with the slices' times, one with every kernel's launches,
error, times and bound, and last ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, when no CUDA device is visible. Imports neither
jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

BF16_ULP = 2.0 ** -7          # spacing of bf16 values in [1, 2)
# f32 summation-order noise, as a share of an element's sum of |terms|: a few
# hundred terms summed in two orders differ by ~sqrt(n) * 2^-24 of it, ~2^-20
F32_SUM_NOISE = 2.0 ** -16
LEVELS = ((60, 108), (30, 54), (15, 27), (8, 14))   # IDOL-R50 at 480x864, strides 8..64
CLIP, HEIGHT, WIDTH = 10, 480, 864
VIDEO_HW = (480, 853)
VIDEO_FRAMES = (20, 13)

# the train step: TPU.TRAIN_IMAGE_SIZE and MAX_INSTANCES of configs/idol/ytvis19_r50.yaml,
# and bench.py's single-chip share of its 32-clip batch
TRAIN_CLIPS, TRAIN_HW, MAX_INSTS = 4, (512, 640), 48
TRAIN_LEVELS = ((64, 80), (32, 40), (16, 20), (8, 10))
TRAIN_STEPS = 6                      # one warm-up step, then 5 timed

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


def stem_serving_case(dev, rng, shape):
    """K2's forward at a serving shape (bf16 frames [N, H, W, 3]) against its
    plain version, its time, bound and cuDNN's bf16 convolution alone."""
    import torch

    from vnext_tpu_torch.ops import stem_conv as stem

    bf16 = torch.bfloat16

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    x = t(rng.randn(*shape))
    k = t(rng.randn(7, 7, 3, 64) * 0.1)
    scale, bias = t(rng.rand(64) + 0.5), t(rng.randn(64) * 0.1)
    got = stem.stem_conv7x7s2_bn_relu(x, k, scale, bias)
    want = stem.stem_conv_plain(x, k, scale, bias)
    torch.cuda.synchronize()
    err = compare(f"K2 stem_conv [{','.join(map(str, shape))}]", got, want, BF16_ULP * float(want.float().abs().max()),
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
    return kernel_entry(err, ms, plain_ms, bound, library_ms)


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

    # K2 stem, at IDOL's clip and at InstMove's call (bench.py's bench_instmove: B = 32 at 128x128)
    results["stem"] = stem_serving_case(dev, rng, (CLIP, HEIGHT, WIDTH, 3))
    results["stem_instmove"] = stem_serving_case(dev, np.random.RandomState(13), (INSTMOVE_BATCH, *INSTMOVE_HW, 3))

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


def read_config(rel: str):
    """A config file under ``configs/`` through the port's own reader, with the
    project's keys (IDOL's, SeqFormer's for ``seqformer/``, MaskFormer's for
    ``minvis/``)."""
    from vnext_tpu_torch.config import add_idol_config, add_maskformer_config, add_seqformer_config, get_cfg

    cfg = get_cfg()
    {"seqformer": add_seqformer_config, "minvis": add_maskformer_config}.get(rel.split("/")[0], add_idol_config)(cfg)
    cfg.merge_from_file(str(Path(__file__).resolve().parent / "configs" / rel))
    return cfg


def synthetic_records():
    """The two synthetic videos as an image store and their YTVIS records."""
    videos = {vid: synthetic_video(vid, n) for vid, n in zip((1, 2), VIDEO_FRAMES)}
    store = {f"v{vid}/{i:05d}.jpg": fr for vid, frames in videos.items() for i, fr in enumerate(frames)}
    records = [
        {"video_id": vid, "height": VIDEO_HW[0], "width": VIDEO_HW[1], "length": len(frames),
         "file_names": [f"v{vid}/{i:05d}.jpg" for i in range(len(frames))]}
        for vid, frames in videos.items()
    ]
    return store, records


def raise_class_bias(model, probe):
    """Random weights score every query alike, below the runners' thresholds
    (the tracker's 0.2 birth score, SeqFormer's 0.05), so no instance would be
    made and the writer would get no work. Raise the last class head's bias of
    class 0 so that a tenth of the probed queries score 0.3 on it: the
    tracker, the mask assembly and the writer then run for real."""
    import torch

    shift = float(np.log(0.3 / 0.7) - np.quantile(probe, 0.9))
    with torch.no_grad():
        getattr(model, f"class_embed_{model.dec_layers - 1}").bias[0] += shift
    print(f"  class-0 bias raised by {shift:.3f} so that random weights make detections")


def check_entries(results, n_classes: int):
    """Every video's ``results.json`` entries well-formed; returns them all."""
    from vnext_tpu_torch.evaluation.ytvis_json import video_output_to_json

    entries = []
    for rec, out in results:
        js = video_output_to_json(out, rec["video_id"])
        for e in js:
            require(set(e) == {"video_id", "score", "category_id", "segmentations"}, f"entry keys {set(e)}")
            require(0.0 <= e["score"] <= 1.0 and 1 <= e["category_id"] <= n_classes, f"bad entry {e['score']}")
            require(len(e["segmentations"]) == rec["length"], "one segmentation per frame")
            require(all(sg["size"] == list(VIDEO_HW) and isinstance(sg["counts"], str)
                        for sg in e["segmentations"]), "RLE size / counts")
        entries += js
    require(len(entries) > 0, "no results.json entries: no instance was made")
    json.dumps(entries)
    return entries


def describe(model, label: str, config: str, t0: float) -> None:
    n = sum(p.numel() for p in model.parameters()) / 1e6
    nb = sum(p.numel() for p in model.backbone.parameters()) / 1e6
    print(f"  {label} from configs/{config} (the port's config reader) built in {time.perf_counter() - t0:.1f} s: "
          f"{n:.2f} M parameters ({nb:.2f} M in the backbone), dtype {model.dtype}, seeded random weights "
          "(the published checkpoints are not in the repository)")


def module_ms(model, fn):
    """Time inside the backbone and inside its Swin window-attention modules
    (qkv, q·kᵀ, bias, mask, softmax, ·v, proj) during one call of ``fn``: CUDA
    events recorded by forward hooks around each, summed (any idle gap
    between their launches included)."""
    import torch

    from vnext_tpu_torch.models.backbones.swin import WindowAttention

    spans = {"backbone": [], "window_attention": []}

    def hooks(module, key):
        def pre(*_):
            spans[key].append([torch.cuda.Event(enable_timing=True)])
            spans[key][-1][0].record()

        def post(*_):
            spans[key][-1].append(torch.cuda.Event(enable_timing=True))
            spans[key][-1][1].record()

        return [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]

    handles = hooks(model.backbone, "backbone")
    for m in model.backbone.modules():
        if isinstance(m, WindowAttention):
            handles += hooks(m, "window_attention")
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}


def forward_profile(model, fn, what: str, reps: int):
    """The forward's time by events (median of ``reps``), peak memory, the
    backbone's and the window attention's time, and the profiler's busy share."""
    import torch

    forward_ms = time_ms(fn, reps=reps, warmup=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    parts = module_ms(model, fn)
    busy, wall = profile_busy(fn, what, top=15)
    print(f"  forward only, {what} on the card (CUDA events, median of {reps}): {forward_ms:.2f} ms; peak memory "
          f"{peak:.2f} GiB; inside the backbone {parts['backbone']:.2f} ms, inside its window attention "
          f"{parts['window_attention']:.2f} ms (events around the modules, one call)")
    return {"forward_ms": forward_ms, "device_busy_ms": busy, "profiled_forward_ms": wall, "peak_gib": peak,
            "backbone_ms": parts["backbone"], "window_attention_ms": parts["window_attention"]}


def phase_main_path(dev, kernels, config="idol/ytvis19_r50.yaml", label="IDOL-R50", tag="3"):
    """IDOL serving from a config file: ``IDOLVideoInference`` on the two
    synthetic videos with the launch counters read, then the forward of a clip
    on the card alone."""
    import torch

    from vnext_tpu_torch.engine.vis_inference import IDOLVideoInference
    from vnext_tpu_torch.models.backbones.resnet import ResNet
    from vnext_tpu_torch.models.idol import build_idol_model

    cfg = read_config(config)
    t0 = time.perf_counter()
    model = build_idol_model(cfg, device=dev, seed=0)
    describe(model, label, config, t0)

    store, records = synthetic_records()
    runner = IDOLVideoInference.from_config(cfg, model, image_loader=store.__getitem__)

    clip_ms, outputs_finite = [], []
    infer = runner.infer_clip

    def timed_clip(frames, size):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = infer(frames, size)
        clip_ms.append((time.perf_counter() - t1) * 1e3)
        outputs_finite.append(all(np.isfinite(v).all() for v in out.values()))
        return out

    first_clip = {**records[0], "file_names": records[0]["file_names"][:CLIP]}
    raise_class_bias(model, infer(*runner._prepare_frames(first_clip))["pred_logits"][..., 0])

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

    n_clips = sum(-(-n // CLIP) for n in VIDEO_FRAMES)
    expected = {"ms_deform_attn_fwd": 12 * n_clips, "encoder_epilogue": 6 * n_clips}
    if isinstance(model.backbone, ResNet):
        expected["stem_conv"] = n_clips
    print(f"  launches over {n_clips} clips: {launches} (expected {expected})")
    require(launches == expected, f"launch counts {launches} != {expected}")
    require(len(outputs_finite) == n_clips and all(outputs_finite), "non-finite model outputs")
    entries = check_entries(results, cfg.MODEL.IDOL.NUM_CLASSES)

    # the forward alone, on a clip already on the card (no host copies)
    frames, size = runner._prepare_frames(first_clip)
    with torch.inference_mode():
        x = (torch.from_numpy(frames).to(dev).float() - runner.pixel_mean) / runner.pixel_std
        sizes = torch.tensor([size] * CLIP, dtype=torch.int32, device=dev)
        timing = forward_profile(model, lambda: model.inference(x, sizes),
                                 f"{label} serving forward ({CLIP}-frame clip at {HEIGHT}x{WIDTH})", reps=10)
    timing["clip_ms"] = statistics.median(clip_ms)
    print(f"  per-clip ms (model, host<->device copies included): "
          f"{', '.join(f'{x:.2f}' for x in clip_ms)}; median {timing['clip_ms']:.2f}")
    print(f"  two videos ({sum(VIDEO_FRAMES)} frames) end to end incl. tracking and masks: {wall:.2f} s; "
          f"{len(entries)} results.json entries")
    print(f"[phase {tag}] {label} serving ran through its kernels; outputs finite; entries well-formed")
    return model, runner, records[0], cfg, launches, timing


# ---------------------------------------------------------------- phase 4
TRUNK_ROUNDINGS = {  # what the serving paths round in sequence, for the tolerances' reasons
    "resnet": "~100 times in sequence (53 convolutions, 12 transformer layers, heads)",
    "swin": "~300 times in sequence (24 Swin blocks of ~10 roundings each, 12 transformer layers, heads)",
}


def trunk_roundings(model) -> str:
    from vnext_tpu_torch.models.backbones.resnet import ResNet

    return TRUNK_ROUNDINGS["resnet" if isinstance(model.backbone, ResNet) else "swin"]


def phase_numerics(model, runner, record, cfg, tag="4"):
    import torch

    from vnext_tpu_torch.models.idol import build_idol_model

    frames, size = runner._prepare_frames({**record, "file_names": record["file_names"][:1]})
    cpu_model = build_idol_model(cfg, device="cpu", dtype=torch.float32, seed=1)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})

    def run(m, device):
        x = torch.from_numpy(frames).to(device).float()
        x = (x - runner.pixel_mean.to(device)) / runner.pixel_std.to(device)
        sizes = torch.tensor([size], dtype=torch.int32, device=device)
        with torch.inference_mode():
            return {k: v.float().cpu() for k, v in m.inference(x, sizes).items()}

    card = run(model, next(model.parameters()).device)
    t0 = time.perf_counter()
    ref = run(cpu_model, "cpu")
    print(f"  CPU f32 reference forward: {time.perf_counter() - t0:.1f} s")

    reason = (f"bf16 keeps 8 significant bits (2^-9 relative per rounding) and the path rounds "
              f"{trunk_roundings(model)}, so errors that add like a random walk reach a few %; 5% leaves headroom")

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
    print(f"[phase {tag}] card (kernels, bf16) agrees with CPU (plain, f32) on frame 0")



# ---------------------------------------------------------------- phase 2b
def phase_train_kernels(dev):
    """K4 and K5 at the train step's shapes (4 frames at 512x640: Q = S = 6800 in
    the encoder, Q = 300 in the decoder), and K2's forward and backward."""
    import torch

    from vnext_tpu_torch.ops import ms_deform_attn as msda

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

    results["stem_train"] = stem_train_case(dev, rng, TRAIN_CLIPS, TRAIN_HW, "train shape")
    print("[phase 2b] K4, K5 (and the v6 route's backward) and K2 agree with their plain versions at "
          "train-step shapes; K2 has a backward")
    return results


def stem_train_case(dev, rng, n, hw, label):
    """K2's forward at [n, *hw, 3] against its plain version, with times, the
    bound and cuDNN's bf16 convolution; then its backward (the autograd of the
    f32 linearization point) against the autograd of the plain version on the
    same batch, with both passes timed. Returns the forward's kernel entry with
    the backward's error and times beside it."""
    import torch

    from vnext_tpu_torch.ops import stem_conv as stem

    bf16 = torch.bfloat16

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)

    shape = f"[{n},{hw[0]},{hw[1]},3]"
    x = t(rng.randn(n, *hw, 3))
    k = t(rng.randn(7, 7, 3, 64) * 0.1)
    scale, bias = t(rng.rand(64) + 0.5), t(rng.randn(64) * 0.1)
    with torch.no_grad():
        got = stem.stem_conv7x7s2_bn_relu(x, k, scale, bias)
        want = stem.stem_conv_plain(x, k, scale, bias)
        torch.cuda.synchronize()
        err = compare(f"K2 stem_conv {shape}", got, want, BF16_ULP * float(want.float().abs().max()),
                      "one bf16 ulp at the largest output: both sum exact products of bf16-rounded "
                      "operands in f32 and round once to bf16, in different orders")
        plain_ms = time_ms(lambda: stem.stem_conv_plain(x, k, scale, bias))
        ms = time_ms(lambda: stem.stem_conv7x7s2_bn_relu(x, k, scale, bias))
        xb = x.to(bf16).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        kb = k.to(bf16).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        library_ms = time_ms(lambda: torch.nn.functional.conv2d(xb, kb, stride=2, padding=3))
    bound = bound_ms(nbytes(x, k, scale, bias, got), 2.0 * got.numel() * 7 * 7 * 3, "bf16")
    print(f"  K2 ({label}, {shape}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN bf16 conv2d "
          f"{library_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]}")
    entry = kernel_entry(err, ms, plain_ms, bound, library_ms)
    del got, want, xb, kb

    # K2's backward: the autograd of the f32 linearization point, against the
    # autograd of the plain version. The plain version rounds the input to bf16
    # before its convolution and the linearization point (as JAX's) does not, so
    # both get an input that bf16 holds exactly: then they linearize at the same
    # point (a ReLU mask that differs on ~0.1% of outputs would otherwise move the
    # random-sign sums by ~sqrt(1e-3) = 3%)
    x = x.to(bf16).float()
    g = t(rng.randn(n, hw[0] // 2, hw[1] // 2, 64), bf16)
    args = (k, scale, bias)

    def grads(fn):
        leaves = [a.clone().requires_grad_() for a in args]
        fn(x, *leaves).backward(g)
        return [a.grad for a in leaves]

    errs = {}
    for name, a, w in zip(("kernel", "scale", "bias"), grads(stem.stem_conv7x7s2_bn_relu),
                          grads(stem.stem_conv_plain)):
        errs[name] = float((a - w).norm() / w.norm())
        print(f"  K2 backward ({label}) d{name}: relative L2 {errs[name]:.3g} tolerance 0.001: the same f32 "
              "products summed in other orders, and dkernel rounded to bf16 on both sides")
        require(errs[name] <= 1e-3, f"K2 backward ({label}) d{name}: relative error {errs[name]}")
    train_ms = time_ms(lambda: grads(stem.stem_conv7x7s2_bn_relu), reps=5, warmup=1)
    plain_train_ms = time_ms(lambda: grads(stem.stem_conv_plain), reps=5, warmup=1)
    print(f"  K2 forward + backward ({label}) {train_ms:.4f} ms, plain's {plain_train_ms:.4f} ms")
    return {**entry, "backward_rel_l2": errs, "forward_backward_ms": train_ms,
            "plain_forward_backward_ms": plain_train_ms}


# ---------------------------------------------------------------- phase 5
def synthetic_batch(rng, n_clips=TRAIN_CLIPS, hw=TRAIN_HW, n_classes=40):
    """A collated loader batch (``batch_to_model_inputs``'s format): key and
    reference frames [B, 512, 640, 3] (``hw``) uint8 with coloured rectangles,
    and up to 48 instances per clip with labels below ``n_classes``, cxcywh
    boxes, stride-4 masks and ids; the reference frame moves each box a little
    and drops a few instances."""
    h, w = hw
    batch = {}
    n_inst = rng.randint(8, MAX_INSTS + 1, size=n_clips)
    centre = rng.rand(n_clips, MAX_INSTS, 2) * 0.7 + 0.15
    extent = rng.rand(n_clips, MAX_INSTS, 2) * 0.25 + 0.05
    labels = rng.randint(0, n_classes, size=(n_clips, MAX_INSTS)).astype(np.int32)
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

    from vnext_tpu_torch.checkpoint.checkpointer import Checkpointer
    from vnext_tpu_torch.engine.hooks import (HookBase, IterationTimer, LRTracker,
                                              PeriodicCheckpointer, PeriodicWriter)
    from vnext_tpu_torch.engine.train_step import TrainState, dropout_generator, make_train_step
    from vnext_tpu_torch.engine.trainer import PIXEL_MEAN, PIXEL_STD, VISTrainer, batch_to_model_inputs
    from vnext_tpu_torch.models.criterion import default_weight_dict
    from vnext_tpu_torch.models.idol import build_idol_model
    from vnext_tpu_torch.solver import build as solver
    from vnext_tpu_torch.utils.events import CommonMetricPrinter, JSONWriter

    cfg = read_config("idol/ytvis19_r50.yaml")   # its SOLVER node
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
            PeriodicCheckpointer(Checkpointer(out_dir), period=TRAIN_STEPS),
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


def phase_seqformer(dev, kernels, config="seqformer/ytvis19_r50.yaml", label="SeqFormer-R50", tag="7"):
    """SeqFormer serving from a config file: both videos whole and the 13-frame
    one clip-matched, with the launch counters read, then a clip's forward."""
    import torch

    from vnext_tpu_torch.engine.seqformer_inference import SeqFormerVideoInference
    from vnext_tpu_torch.models.backbones.resnet import ResNet
    from vnext_tpu_torch.models.seqformer import build_seqformer_model

    cfg = read_config(config)
    t0 = time.perf_counter()
    model = build_seqformer_model(cfg, device=dev, seed=0)
    describe(model, label, config, t0)
    store, records = synthetic_records()
    whole = SeqFormerVideoInference.from_config(cfg, model, image_loader=store.__getitem__)
    matched = SeqFormerVideoInference.from_config(cfg, model, clip_matching=True, image_loader=store.__getitem__)

    frames, size = whole._prepare_frames({**records[0], "file_names": records[0]["file_names"][:CLIP]})
    sizes = torch.tensor([size], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        x = ((torch.from_numpy(frames).to(dev).float() - whole.pixel_mean) / whole.pixel_std)[None]
        probe = model.inference(x, sizes)["pred_logits"][:, 0].float().cpu().numpy()
    raise_class_bias(model, probe)

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

    n_clips = len(records) + window_count(VIDEO_FRAMES[1], matched.clip_length, matched.clip_stride)
    expected = {"ms_deform_attn_fwd": 6 * n_clips, "encoder_epilogue": 6 * n_clips,
                "ms_deform_attn_v9_fwd": 6 * n_clips}
    stem = isinstance(model.backbone, ResNet)
    if stem:
        expected["stem_conv"] = n_clips
    print(f"  launches over {n_clips} clips (2 whole videos, then the {VIDEO_FRAMES[1]}-frame one in windows "
          f"of {matched.clip_length}): {launches} (expected {expected}: per clip {'one stem, ' if stem else ''}"
          "6 encoder layers of K1's point form and K3, 6 decoder layers of K4 at batch nf, no K1 box form)")
    require(launches == expected, f"launch counts {launches} != {expected}")
    require(len(finite) == n_clips and all(finite), "non-finite SeqFormer outputs")
    entries = check_entries(results, cfg.MODEL.SeqFormer.NUM_CLASSES)

    with torch.inference_mode():
        timing = forward_profile(model, lambda: model.inference(x, sizes),
                                 f"{label} forward ({CLIP}-frame clip at {HEIGHT}x{WIDTH})", reps=5)
    timing["clip_ms_by_frames"] = clip_ms
    print(f"  per-clip ms through the runner (forward, top-10 on the card, their masks to the host), "
          f"as frames: ms: {', '.join(f'{n}: {v:.2f}' for n, v in clip_ms)}")
    print(f"  2 videos whole + 1 clip-matched ({VIDEO_FRAMES[0] + 2 * VIDEO_FRAMES[1]} frames) end to end: "
          f"{wall:.2f} s; {len(entries)} results.json entries")
    print(f"[phase {tag}] {label} ran through its kernels; outputs finite; entries well-formed")
    return model, whole, records[0], cfg, launches, timing


def phase_seqformer_numerics(model, runner, record, cfg, tag="8"):
    import torch

    from vnext_tpu_torch.models.seqformer import build_seqformer_model

    frames, size = runner._prepare_frames({**record, "file_names": record["file_names"][:2]})
    cpu_model = build_seqformer_model(cfg, device="cpu", dtype=torch.float32, seed=1)
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
    reason = (f"bf16 keeps 8 significant bits and the path rounds {trunk_roundings(model)}, so errors that add "
              "like a random walk reach a few %")
    box_err = float((card["pred_boxes"] - ref["pred_boxes"]).abs().max())
    print(f"  pred_boxes: max_abs_err {box_err:.4g} tolerance 0.05: sigmoids with slope <= 1/4")
    require(box_err <= 0.05, f"pred_boxes error {box_err}")
    top = ref["pred_logits"].max(-1).values.topk(10).indices
    for name, a, b in (("pred_logits (top-10 queries)", card["pred_logits"][top], ref["pred_logits"][top]),
                       ("pred_masks", card["pred_masks"], ref["pred_masks"])):
        err = float((a - b).norm() / b.norm().clamp_min(1e-30))
        print(f"  {name}: relative L2 error {err:.4g} tolerance 0.05: {reason}")
        require(err <= 0.05, f"{name}: relative error {err}")
    print(f"[phase {tag}] SeqFormer card (kernels, bf16) agrees with CPU (plain, f32) on a 2-frame clip")


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

    cfg = read_config("idol/ytvis19_r50.yaml")   # its SOLVER node
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
    store, records = synthetic_records()
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


# ---------------------------------------------------------------- phase 16
def phase_r101_and_import(dev, kernels, swin_model, swin_cfg):
    """IDOL-R101 from its config file: one clip with the launch counters read,
    its forward's profile, card vs CPU on one frame. Then IDOL-Swin-L's seeded
    state, written out under the reference's names as a ``.pth``, imported
    into a model of another seed: a clean report, and outputs equal bit for
    bit to the seeded model's on a clip."""
    import torch

    from vnext_tpu_torch.checkpoint.torch_import import load_reference_weights, to_reference_names
    from vnext_tpu_torch.engine.vis_inference import IDOLVideoInference
    from vnext_tpu_torch.models.idol import build_idol_model

    config = "idol/ytvis19_r101.yaml"
    cfg = read_config(config)
    t0 = time.perf_counter()
    model = build_idol_model(cfg, device=dev, seed=0)
    describe(model, "IDOL-R101", config, t0)
    require(len(model.backbone.stage_blocks[2]) == 23 and model.backbone.layer2_0.conv2.stride == 2,
            "IDOL-R101: 23 blocks in res4, the stride on the 3x3 (STRIDE_IN_1X1 False)")
    store, records = synthetic_records()
    runner = IDOLVideoInference.from_config(cfg, model, image_loader=store.__getitem__)
    frames, size = runner._prepare_frames({**records[0], "file_names": records[0]["file_names"][:CLIP]})
    runner.infer_clip(frames, size)         # warm-up, not counted
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = runner.infer_clip(frames, size)
    clip_ms = (time.perf_counter() - t1) * 1e3
    launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}
    expected = {"ms_deform_attn_fwd": 12, "stem_conv": 1, "encoder_epilogue": 6}
    print(f"  launches over one clip: {launches} (expected {expected}); {clip_ms:.2f} ms through the runner")
    require(launches == expected, f"launch counts {launches} != {expected}")
    require(all(np.isfinite(v).all() for v in out.values()), "non-finite IDOL-R101 outputs")
    with torch.inference_mode():
        x = (torch.from_numpy(frames).to(dev).float() - runner.pixel_mean) / runner.pixel_std
        sizes = torch.tensor([size] * CLIP, dtype=torch.int32, device=dev)
        timing = forward_profile(model, lambda: model.inference(x, sizes),
                                 f"IDOL-R101 serving forward ({CLIP}-frame clip at {HEIGHT}x{WIDTH})", reps=10)
    timing["clip_ms"] = clip_ms
    phase_numerics(model, runner, records[0], cfg, tag="16")
    del model, runner
    torch.cuda.empty_cache()

    # the same clip (both files normalize alike) through the seeded IDOL-Swin-L and its imported copy
    state = {k: v.detach().cpu() for k, v in swin_model.state_dict().items()}
    reference = {f"module.{k}": v for k, v in to_reference_names(state, "idol").items()}
    fresh = build_idol_model(swin_cfg, device=dev, seed=1)
    require(not torch.equal(fresh.query_embed, swin_model.query_embed), "the second seed made the same weights")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "idol_swinL_seeded.pth"
        torch.save({"model": reference}, path)
        megabytes = path.stat().st_size / 2 ** 20
        t0 = time.perf_counter()
        report = load_reference_weights(str(path), fresh)
        load_s = time.perf_counter() - t0
    print(f"  IDOL-Swin-L's state under the reference's names ({len(reference)} tensors, {megabytes:.0f} MiB, "
          f"'module.' prefixed) imported in {load_s:.1f} s: {report['matched']} of {len(state)} matched, "
          f"missing {report['missing'][:5]}, unused {report['unused'][:5]}, shape mismatches "
          f"{report['shape_mismatch'][:5]}")
    require(report["matched"] == len(state) and not (report["missing"] or report["unused"]
                                                     or report["shape_mismatch"]), "the import report is not clean")
    with torch.inference_mode():
        want = swin_model.inference(x, sizes)
        got = fresh.inference(x, sizes)
    differing = [k for k in want if not torch.equal(got[k], want[k])]
    print(f"  imported vs seeded IDOL-Swin-L on a {CLIP}-frame clip: outputs {sorted(want)} equal bit for bit "
          f"except {differing}")
    require(not differing, f"the imported model's {differing} differ from the seeded model's")
    print("[phase 16] IDOL-R101 ran through K1 / K2 / K3 and agrees with the CPU; the reference-format "
          "IDOL-Swin-L import is clean and exact")
    return launches, timing, {"tensors": len(reference), "mib": megabytes, "load_s": load_s,
                              "matched": report["matched"], "outputs_bit_equal": not differing}


# ---------------------------------------------------------------- phase 17
ENTRY_DATASET = "ytvis_synthetic_entry_point"
ENTRY_TRAIN_STEPS, ENTRY_RESUME_STEPS = 4, 6
ENTRY_CHECKPOINT_PERIOD = 2
ENTRY_STEADY_STEPS = 20       # step periods taken in each steady run (--only entry_point)


@contextlib.contextmanager
def patched(owner, name, value):
    """``owner.name`` replaced by ``value`` inside the block."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def zero(kernels):
    for kern in kernels.values():
        kern.launches = 0


def counts(kernels):
    return {name: kern.launches for name, kern in kernels.items() if kern.launches}


def minus(a, b):
    return {k: a.get(k, 0) - b.get(k, 0) for k in a if a.get(k, 0) - b.get(k, 0)}


def register_synthetic(root, name, classes, num_frames=VIDEO_FRAMES[0]):
    """The synthetic YTVIS-format dataset (2 videos x ``num_frames`` frames at
    480x853) under ``root``, its json listing ``classes`` as its categories (the
    synthetic objects take ids 1-3), registered as ``name``: every label of a
    model of that many classes then has a dataset category, as on the real
    dataset (phase 17: YouTube-VIS 2019's 40; phase 18: OVIS's 25)."""
    from vnext_tpu_torch.data.datasets.synthetic import generate_synthetic_ytvis
    from vnext_tpu_torch.data.datasets.ytvis import register_ytvis_instances

    json_file = generate_synthetic_ytvis(root, h=VIDEO_HW[0], w=VIDEO_HW[1], num_frames=num_frames)
    with open(json_file) as f:
        data = json.load(f)
    data["categories"] = [{"id": i + 1, "name": n} for i, n in enumerate(classes)]
    with open(json_file, "w") as f:
        json.dump(data, f)
    register_ytvis_instances(name, {"thing_classes": list(classes)}, json_file, f"{root}/JPEGImages")


def ground_truth_outputs(records):
    """Each video's ground truth as a runner's output: one instance per
    annotation id, its mask on every frame where it is annotated, score 1."""
    from vnext_tpu_torch.data.dataset_mapper import decode_segmentation

    outputs = []
    for rec in records:
        h, w = rec["height"], rec["width"]
        insts = {}
        for f, objs in enumerate(rec["annotations"]):
            for o in objs:
                entry = insts.setdefault(o["id"], {"label": o["category_id"], "masks": [None] * rec["length"]})
                entry["masks"][f] = decode_segmentation(o["segmentation"], h, w)
        outputs.append({"image_size": (h, w), "pred_scores": [1.0] * len(insts),
                        "pred_labels": [v["label"] for v in insts.values()],
                        "pred_masks": [v["masks"] for v in insts.values()]})
    return outputs


def check_stats(stats, what):
    """The evaluator's keys, each a finite fraction in [0, 1], or NaN where an
    area bin holds no ground truth (the evaluator reports fractions: 1.0 is an
    AP of 100)."""
    keys = {"AP", "AP50", "AP75", "APs", "APm", "APl", "AR@1", "AR@10", "AR@100"}
    require(set(stats) == keys, f"{what}: stats keys {sorted(stats)}")
    for k, v in stats.items():
        require(np.isnan(v) or 0.0 <= v <= 1.0, f"{what}: {k} = {v}")
    require(all(np.isfinite(stats[k]) for k in ("AP", "AP50", "AP75", "AR@100")), f"{what}: {stats}")


def phase_entry_point(dev, kernels, smi, measure=False):
    """IDOL through the port's own entry point (``vnext_tpu_torch.tools.train_net.main``,
    in-process) on a synthetic YTVIS dataset of 2 videos x 20 frames at 480x853:
    ``--eval-only`` at ytvis19_r50 width, the ground truth through the
    evaluator, training with periodic checkpoints, and ``--resume``. With
    ``measure``, also the steady step (``entry_point_steady``) and a host
    profile of ``--eval-only``."""
    import torch

    from vnext_tpu_torch.checkpoint.checkpointer import Checkpointer
    from vnext_tpu_torch.data import DatasetCatalog
    from vnext_tpu_torch.data.datasets.ytvis import YTVIS_2019_CLASSES
    from vnext_tpu_torch.evaluation import native
    from vnext_tpu_torch.evaluation.ytvis_eval import YTVISEvaluator
    from vnext_tpu_torch.tools import train_net

    t_phase = time.perf_counter()
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        register_synthetic(f"{tmp}/data", ENTRY_DATASET, YTVIS_2019_CLASSES)
        records = DatasetCatalog.get(ENTRY_DATASET)
        print(f"  synthetic YTVIS dataset: {len(records)} videos x {records[0]['length']} frames at "
              f"{records[0]['height']}x{records[0]['width']} (PNG), {sum(len(r['annotations'][0]) for r in records)} "
              f"instances, written in {time.perf_counter() - t0:.1f} s")
        config = str(Path(__file__).resolve().parent / "configs" / "idol" / "ytvis19_r50.yaml")
        common = ["--config-file", config, "MODEL.WEIGHTS", "", "DATASETS.TEST", f"('{ENTRY_DATASET}',)",
                  "DATASETS.TRAIN", f"('{ENTRY_DATASET}',)"]

        # ---- --eval-only
        video_ms, evaluate_s = [], []
        build_model, build_evaluator = train_net.build_idol_model, train_net.build_evaluator

        def model_with_detections(cfg, device, seed=0):
            """The entry point's seeded model, its class-0 bias raised as phase 3
            does so that tracks are born; the counters zeroed after the probe."""
            model = build_model(cfg, device=device, seed=seed)
            runner = train_net.IDOLVideoInference.from_config(cfg, model)
            first = {**records[0], "file_names": records[0]["file_names"][:CLIP]}
            raise_class_bias(model, runner.infer_clip(*runner._prepare_frames(first))["pred_logits"][..., 0])
            torch.cuda.synchronize()
            zero(kernels)
            return model

        class TimedRunner(train_net.IDOLVideoInference):
            def __call__(self, record):
                t1 = time.perf_counter()
                out = super().__call__(record)
                video_ms.append((time.perf_counter() - t1) * 1e3)
                return out

        def timed_evaluator(cfg, name):
            ev = build_evaluator(cfg, name)
            evaluate = ev.evaluate

            def timed():
                t1 = time.perf_counter()
                out = evaluate()
                evaluate_s.append(time.perf_counter() - t1)
                return out

            ev.evaluate = timed
            return ev

        eval_dir = f"{tmp}/eval"
        zero(kernels)
        with patched(train_net, "build_idol_model", model_with_detections), \
                patched(train_net, "IDOLVideoInference", TimedRunner), \
                patched(train_net, "build_evaluator", timed_evaluator):
            results = train_net.main(["--eval-only", *common, "OUTPUT_DIR", eval_dir])
        torch.cuda.synchronize()
        eval_launches = counts(kernels)
        n_clips = len(records) * -(-VIDEO_FRAMES[0] // CLIP)
        expected = {"ms_deform_attn_fwd": 12 * n_clips, "stem_conv": n_clips, "encoder_epilogue": 6 * n_clips}
        print(f"  --eval-only: launches over {n_clips} clips {eval_launches} (expected {expected})")
        require(eval_launches == expected, f"eval launch counts {eval_launches} != {expected}")
        with open(f"{eval_dir}/results.json") as f:
            entries = json.load(f)
        require(len(entries) > 0, "--eval-only wrote no results.json entry")
        for e in entries:
            require(set(e) == {"video_id", "score", "category_id", "segmentations"}, f"entry keys {set(e)}")
            require(0.0 <= e["score"] <= 1.0 and 1 <= e["category_id"] <= 40, f"bad entry {e['score']}")
            require(len(e["segmentations"]) == VIDEO_FRAMES[0] and all(
                sg["size"] == list(VIDEO_HW) for sg in e["segmentations"]), "one 480x853 RLE per frame")
        stats = results[ENTRY_DATASET]["segm"]
        check_stats(stats, "--eval-only")
        print(f"  --eval-only: {len(entries)} results.json entries; AP dict {stats}; per video "
              f"{', '.join(f'{v:.1f}' for v in video_ms)} ms through do_eval (decode, clips, tracker, masks; "
              f"seeded weights); the evaluator {evaluate_s[0]:.3f} s (results.json and the tube-IoU AP)")
        result["eval"] = {"video_ms": list(video_ms), "evaluator_s": evaluate_s[0], "entries": len(entries),
                          "stats": stats}
        torch.cuda.empty_cache()

        if measure:
            # the host's time in --eval-only by function (the main thread; the card's work is
            # asynchronous, so waits on it show in the calls that synchronize)
            import cProfile
            import io
            import pstats

            video_ms.clear()
            evaluate_s.clear()
            profiler = cProfile.Profile()
            with patched(train_net, "build_idol_model", model_with_detections), \
                    patched(train_net, "IDOLVideoInference", TimedRunner), \
                    patched(train_net, "build_evaluator", timed_evaluator):
                t0 = time.perf_counter()
                profiler.enable()
                train_net.main(["--eval-only", *common, "OUTPUT_DIR", f"{tmp}/eval_profiled"])
                profiler.disable()
                wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            for order in ("tottime", "cumulative"):
                text = io.StringIO()
                pstats.Stats(profiler, stream=text).strip_dirs().sort_stats(order).print_stats(22)
                rows = text.getvalue().splitlines()
                start = next(i for i, r in enumerate(rows) if r.lstrip().startswith("ncalls"))
                print(f"  --eval-only under cProfile, {wall:.2f} s (per video "
                      f"{', '.join(f'{v:.1f}' for v in video_ms)} ms, the evaluator {evaluate_s[0]:.3f} s; "
                      f"the model's build and the class-bias probe included), top functions by {order}:")
                for r in rows[start:]:
                    if r.strip():
                        print(f"    {r.strip()[:170]}")
            result["eval_profile"] = {"wall_s": wall, "video_ms": list(video_ms), "evaluator_s": evaluate_s[0]}
            torch.cuda.empty_cache()

        # ---- the ground truth as predictions
        require(native.available(), "the evaluator's native C library did not build on this machine")
        ev = YTVISEvaluator(ENTRY_DATASET, output_dir=f"{tmp}/gt")
        ev.reset()
        for rec, out in zip(records, ground_truth_outputs(records)):
            ev.process([rec], [out])
        t0 = time.perf_counter()
        gt_stats = ev.evaluate()["segm"]
        gt_s = time.perf_counter() - t0
        check_stats(gt_stats, "ground truth")
        print(f"  the ground truth as predictions through YTVISEvaluator (native C tube IoU and matching): "
              f"{gt_stats} in {gt_s:.3f} s")
        require(gt_stats["AP"] == 1.0, f"the ground truth scored AP {gt_stats['AP']}, not 1.0 (100%)")
        result["ground_truth_stats"] = gt_stats

        # ---- training and --resume
        train_dir = f"{tmp}/train"
        train = ["--config-file", config, *common[2:], "OUTPUT_DIR", train_dir, "SOLVER.IMS_PER_BATCH",
                 str(TRAIN_CLIPS), "SOLVER.CHECKPOINT_PERIOD", str(ENTRY_CHECKPOINT_PERIOD)]
        step_starts, waits, eval_deltas, saves, loads = [], [], [], [], []
        do_eval, build_loader = train_net.do_eval, train_net.build_vis_train_loader
        save, resume_or_load = Checkpointer.save, Checkpointer.resume_or_load

        class TimedTrainer(train_net.VISTrainer):
            def run_step(self):
                step_starts.append(time.perf_counter())
                super().run_step()

        class TimedLoader:
            def __init__(self, it):
                self._it = it

            def __iter__(self):
                return self

            def __next__(self):
                t1 = time.perf_counter()
                batch = next(self._it)
                waits.append((time.perf_counter() - t1) * 1e3)
                return batch

        def counted_eval(cfg, model=None):
            before = counts(kernels)
            out = do_eval(cfg, model)
            torch.cuda.synchronize()
            eval_deltas.append(minus(counts(kernels), before))
            return out

        def timed_save(self, name, state):
            t1 = time.perf_counter()
            path = save(self, name, state)
            saves.append((t1, time.perf_counter(), os.path.getsize(path)))
            return path

        loaded = {}

        def checked_resume(self, weights_path, state, resume=True):
            path = self.get_checkpoint_file()
            t1 = time.perf_counter()
            state, start = resume_or_load(self, weights_path, state, resume)
            torch.cuda.synchronize()
            loads.append(time.perf_counter() - t1)
            if resume:
                saved = torch.load(path, map_location="cpu", weights_only=True)
                loaded.update(path=path, start=start, saved=saved, lr=[g["lr"] for g in state.optimizer.param_groups],
                              model=all(torch.equal(v.cpu(), saved["model"][k])
                                        for k, v in state.model.state_dict().items()),
                              optimizer=same_optimizer_state(state.optimizer.state_dict(), saved["optimizer"]),
                              scheduler=state.scheduler.state_dict() == saved["scheduler"])
            return state, start

        runs = {}
        for label, argv, steps in (("train", [*train, "SOLVER.MAX_ITER", str(ENTRY_TRAIN_STEPS)], ENTRY_TRAIN_STEPS),
                                   ("resume", ["--resume", *train, "SOLVER.MAX_ITER", str(ENTRY_RESUME_STEPS)],
                                    ENTRY_RESUME_STEPS)):
            step_starts.clear()
            waits.clear()
            eval_deltas.clear()
            zero(kernels)
            t0 = time.perf_counter()
            with patched(train_net, "VISTrainer", TimedTrainer), \
                    patched(train_net, "build_vis_train_loader", lambda *a, **k: TimedLoader(build_loader(*a, **k))), \
                    patched(train_net, "do_eval", counted_eval), \
                    patched(Checkpointer, "save", timed_save), patched(Checkpointer, "resume_or_load", checked_resume):
                trainer = train_net.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            total = counts(kernels)
            require(len(eval_deltas) == 1, f"{label}: {len(eval_deltas)} evaluations, expected the one after training")
            in_eval = eval_deltas[0]
            in_train = minus(total, in_eval)
            n = steps - trainer.start_iter
            expected_train = {"ms_deform_attn_v9_fwd": 24 * n, "ms_deform_attn_v9_bwd": 24 * n, "stem_conv": 2 * n}
            print(f"  {label}: iterations {trainer.start_iter}..{trainer.iter - 1}; launches in the train steps "
                  f"{in_train} (expected {expected_train}), in the evaluation after training {in_eval} "
                  f"(expected K1 / K2 / K3 = {expected['ms_deform_attn_fwd']} / {expected['stem_conv']} / "
                  f"{expected['encoder_epilogue']}, no K4)")
            require(in_train == expected_train, f"{label}: train launch counts {in_train} != {expected_train}")
            require(in_eval == expected, f"{label}: evaluation launch counts {in_eval} != {expected}")
            hist = trainer.storage.histories()
            losses = sorted(k for k in hist if k.startswith("loss_")) + ["total_loss"]
            for k in losses:
                require(hist[k].count() == n and np.isfinite(hist[k].values()).all(), f"{label} {k}: {hist[k].values()}")
            with open(f"{train_dir}/metrics.json") as f:
                written = [json.loads(line) for line in f]
            marker = Path(f"{train_dir}/last_checkpoint").read_text()
            require(marker == f"model_{steps - 1:07d}.pth", f"{label}: last_checkpoint names {marker}")
            require(any("total_loss" in w and w["iteration"] == steps for w in written),
                    f"{label}: metrics.json lacks the last step's losses")
            # from one step's start to the next, less the checkpoint saved between them
            periods = [(b - a - sum(e - s for s, e, _ in saves if a <= s < b)) * 1e3
                       for a, b in zip(step_starts, step_starts[1:])]
            runs[label] = {"iterations": [trainer.start_iter, trainer.iter], "launches": in_train,
                           "eval_launches": in_eval, "step_period_ms": periods,
                           "step_ms": statistics.median(periods[1:] if len(periods) > 1 else periods),
                           "loader_wait_ms": list(waits), "loader_wait_median_ms": statistics.median(waits[1:] or waits),
                           "total_loss": hist["total_loss"].values(), "wall_s": wall}
            print(f"  {label}: total_loss {', '.join(f'{v:.3f}' for v in hist['total_loss'].values())}; "
                  f"metrics.json ({len(written)} lines) and {marker} written; {wall:.1f} s with the evaluation")
            print(f"  {label}: step period through the entry point (host clock between step starts, less a "
                  f"checkpoint save between them; no synchronization added) "
                  f"{', '.join(f'{v:.1f}' for v in periods)} ms, median after the first "
                  f"{runs[label]['step_ms']:.1f}; next(loader) blocked {', '.join(f'{v:.1f}' for v in waits)} ms, "
                  f"median after the first {runs[label]['loader_wait_median_ms']:.1f}")
            del trainer
            torch.cuda.empty_cache()

        require(loaded.get("start") == ENTRY_TRAIN_STEPS, f"--resume started at {loaded.get('start')}")
        lr = train_net.build_lr_schedule(read_config("idol/ytvis19_r50.yaml"))(ENTRY_TRAIN_STEPS)
        want_lr = [lr * 0.1, lr]                 # the backbone group at BACKBONE_MULTIPLIER, then the rest
        require(all(abs(a - b) <= 1e-12 * b for a, b in zip(loaded["lr"], want_lr)),
                f"--resume learning rates {loaded['lr']}, the schedule's for iteration 4 {want_lr}")
        require(loaded["model"] and loaded["optimizer"] and loaded["scheduler"],
                f"--resume restored state differs from {loaded['path']}: model {loaded['model']}, optimizer "
                f"{loaded['optimizer']}, scheduler {loaded['scheduler']}")
        save_s = [e - s for s, e, _ in saves]
        size_mib = saves[-1][2] / 2 ** 20
        print(f"  --resume from {Path(loaded['path']).name}: started at iteration {loaded['start']} at learning rates "
              f"{loaded['lr']} (the schedule's for iteration 4); model, optimizer and scheduler state equal to the "
              f"file bit for bit")
        print(f"  checkpoints: {len(saves)} saved in {', '.join(f'{s:.2f}' for s in save_s)} s, "
              f"{size_mib:.1f} MiB each; resume_or_load (torch.load + restore onto the card) {loads[-1]:.2f} s")
        result.update(train=runs["train"], resume=runs["resume"], checkpoint_save_s=save_s,
                      checkpoint_mib=size_mib, checkpoint_load_s=loads[-1])
        if measure:
            result["steady"] = entry_point_steady(kernels, [*train, "OUTPUT_DIR", f"{tmp}/steady"])
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"  {smi}")
    print(f"[phase 17] the entry point: --eval-only K1 / K2 / K3 = {expected['ms_deform_attn_fwd']} / "
          f"{expected['stem_conv']} / {expected['encoder_epilogue']}, the ground truth AP 1.0, training and --resume "
          f"through K4 / K5 / K2 = 24 / 24 / 2 per step, the state restored bit for bit; {result['phase_s']:.1f} s")
    return {"entry_eval": eval_launches, "entry_train": runs["train"]["launches"]}, result


def entry_point_steady(kernels, train):
    """The entry point's steady step: ``ENTRY_STEADY_STEPS`` step periods after
    a first step of warm-up, no checkpoint saved and no evaluation inside the
    window (the one save follows the last step's start, the evaluation after
    training is skipped). Runs alternate the live loader (its prefetch thread
    mapping beside the steps) and the same batches made beforehand (no thread),
    twice each; the model, the seeds and the batches are the same in every run."""
    import torch

    from vnext_tpu_torch.tools import train_net

    steps = ENTRY_STEADY_STEPS + 2
    argv = [*train, "SOLVER.MAX_ITER", str(steps), "SOLVER.CHECKPOINT_PERIOD", str(10 * steps)]
    build_loader = train_net.build_vis_train_loader
    batches, step_starts, waits = [], [], []

    class TimedTrainer(train_net.VISTrainer):
        def run_step(self):
            step_starts.append(time.perf_counter())
            super().run_step()

    def live_loader(*a, **k):
        it = build_loader(*a, **k)

        def gen():
            while True:
                t1 = time.perf_counter()
                batch = next(it)
                waits.append((time.perf_counter() - t1) * 1e3)
                if len(batches) < steps:
                    batches.append(batch)
                yield batch

        return gen()

    runs = {"live": [], "premade": []}
    for source in ("live", "premade", "live", "premade"):
        step_starts.clear()
        waits.clear()
        zero(kernels)
        loader = live_loader if source == "live" else (lambda *a, **k: iter(list(batches)))
        with patched(train_net, "VISTrainer", TimedTrainer), patched(train_net, "build_vis_train_loader", loader), \
                patched(train_net, "do_eval", lambda cfg, model=None: {}):
            trainer = train_net.main(argv)
        torch.cuda.synchronize()
        n = trainer.iter - trainer.start_iter
        expected = {"ms_deform_attn_v9_fwd": 24 * n, "ms_deform_attn_v9_bwd": 24 * n, "stem_conv": 2 * n}
        require(counts(kernels) == expected, f"steady {source}: launches {counts(kernels)} != {expected}")
        require(np.isfinite(trainer.storage.history("total_loss").values()).all(), f"steady {source}: a loss")
        periods = [(b - a) * 1e3 for a, b in zip(step_starts, step_starts[1:])][1:]
        require(len(periods) == ENTRY_STEADY_STEPS, f"steady {source}: {len(periods)} periods")
        run = {"periods_ms": periods, "median_ms": statistics.median(periods),
               "loader_wait_ms": list(waits[1:]) if source == "live" else []}
        runs[source].append(run)
        wait = (f"; next(loader) blocked median {statistics.median(run['loader_wait_ms']):.2f} ms, max "
                f"{max(run['loader_wait_ms']):.2f}" if source == "live" else "")
        print(f"  steady step, {source} batches: {ENTRY_STEADY_STEPS} periods median {run['median_ms']:.1f} ms "
              f"(min {min(periods):.1f}, max {max(periods):.1f}){wait}")
        del trainer
        torch.cuda.empty_cache()
    live = statistics.median([v for r in runs["live"] for v in r["periods_ms"]])
    premade = statistics.median([v for r in runs["premade"] for v in r["periods_ms"]])
    print(f"  steady step through the entry point (host clock between step starts, {2 * ENTRY_STEADY_STEPS} "
          f"periods each): live loader median {live:.1f} ms, batches made beforehand {premade:.1f} ms, "
          f"ratio {live / premade:.4f}")
    return {"runs": runs, "live_median_ms": live, "premade_median_ms": premade}


def same_optimizer_state(a, b):
    """Two optimizer state dicts equal: the groups' values and every state tensor bit for bit."""
    import torch

    if a["param_groups"] != b["param_groups"] or a["state"].keys() != b["state"].keys():
        return False
    return all(torch.equal(a["state"][i][k].cpu(), b["state"][i][k].cpu()) for i in a["state"] for k in a["state"][i])


# ---------------------------------------------------------------- phase 2b, the new train steps' shapes
# MinVIS-R50's train step (configs/minvis/ovis_r50.yaml: TPU.TRAIN_IMAGE_SIZE 512x768, one card's
# share of IMS_PER_BATCH 16 on 8 cards: 2 clips of key + reference frame), its pixel decoder's
# levels coarsest first (strides 32, 16, 8)
MINVIS_TRAIN_CLIPS, MINVIS_TRAIN_HW = 2, (512, 768)
MINVIS_TRAIN_LEVELS = ((16, 24), (32, 48), (64, 96))
# SeqFormer-R50's train step (configs/seqformer/ytvis19_r50.yaml: 512x640, MAX_INSTANCES 24, clips
# of INPUT.SAMPLING_FRAME_NUM 5 frames), 4 clips as bench.py's single-chip share of its batch
SEQ_TRAIN_CLIPS, SEQ_TRAIN_FRAMES, SEQ_MAX_INSTS, SEQ_TRAIN_STEPS = 4, 5, 24, 3


def msda_train_case(dev, rng, label, levels, b, q, box, backward):
    """K4 (and K5 with ``backward``) at ``levels`` against their plain versions,
    with times, the bound and K4's gather rate; ``box``: the locations are the
    decoder's box form (``sampling_locations`` of box references)."""
    import torch

    from vnext_tpu_torch.models.deformable_transformer import sampling_locations
    from vnext_tpu_torch.ops import ms_deform_attn as msda

    bf16 = torch.bfloat16
    m, d, l, p = 8, 32, len(levels), 4
    s = sum(h * w for h, w in levels)
    wh = np.asarray([[w, h] for h, w in levels], np.float64)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)

    value = t(rng.randn(b, s, m, d), bf16)
    if box:
        ref = np.concatenate([rng.rand(b, q, l, 2) * 0.8 + 0.1, rng.rand(b, q, l, 2) * 0.4 + 0.02], -1)
        off = t(rng.randn(b, q, m, l, p, 2) * 3.0, bf16)
        loc = sampling_locations(levels, off, t(ref)).contiguous()
    else:
        loc = rng.rand(b, q, m, l, p, 2) * 1.2 - 0.1
        k = rng.randint(0, 10 ** 6, size=loc.shape) % wh[None, None, None, :, None, :].astype(int)
        centre = rng.rand(b, q, m, l, p) < 0.25
        loc[centre] = ((k + 0.5) / wh[None, None, None, :, None, :])[centre]
        far = rng.rand(b, q, m, l, p) < 0.02
        loc[far] = rng.choice([-4.0, 5.0], size=(int(far.sum()), 2))
        loc = t(loc)
    logits = torch.from_numpy(rng.randn(b, q, m, l * p).astype(np.float32) * 2.0).to(dev)
    attn = torch.softmax(logits, -1).to(bf16).view(b, q, m, l, p).contiguous()
    pix = loc * torch.tensor(wh, dtype=torch.float32, device=dev)[:, None, :] - 0.5
    with torch.no_grad():
        got = msda.ms_deform_attn_standard(value, levels, loc, attn, "pallas_v9")
    want = msda.ms_deform_attn_core_plain(value, levels, loc, attn)
    torch.cuda.synchronize()
    err = compare(f"K4 ms_deform_attn_v9_fwd ({label}, B={b}, Q={q}, L*P={l * p})", got, want,
                  BF16_ULP * float(want.float().abs().max()),
                  "one bf16 ulp at the largest output: both sum the same bf16 inputs in f32 and round once")
    with torch.no_grad():
        ms = time_ms(lambda: msda.ms_deform_attn_standard(value, levels, loc, attn, "pallas_v9"))
    plain_ms = time_ms(lambda: msda.ms_deform_attn_core_plain(value, levels, loc, attn))
    bound = bound_ms(nbytes(value, loc, attn, got), 10.0 * samples_in_range(pix, levels, strict=True) * d, "f32")
    print(f"  K4 ({label}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]}; "
          f"{gathered(pix, levels, ms)}")
    out = {"fwd": kernel_entry(err, ms, plain_ms, bound)}
    if not backward:
        return out
    grad = t(rng.randn(b, q, m * d), bf16)
    dv, dl, da = msda.ms_deform_attn_v9_backward(value, levels, loc, attn, grad)
    wv, wl, wa = msda.ms_deform_attn_grad_plain(value, levels, loc, attn, grad)
    sv, _, sa = msda.ms_deform_attn_grad_plain(value.abs(), levels, loc, attn, grad.abs())
    torch.cuda.synchronize()
    err_v = compare_each(f"K5 dvalue ({label})", dv, wv, sv)
    err_a = compare_each(f"K5 dattn ({label})", da, wa, sa)
    err_l = compare(f"K5 dloc ({label})", dl, wl, 1e-5 * float(wl.abs().max()),
                    "1e-5 of the largest element: f32 sums of the same products in another order")
    ms = time_ms(lambda: msda.ms_deform_attn_v9_backward(value, levels, loc, attn, grad))
    plain_ms = time_ms(lambda: msda.ms_deform_attn_grad_plain(value, levels, loc, attn, grad))
    bound = bound_ms(nbytes(value, loc, attn, grad, dv, dl, da),
                     30.0 * samples_in_range(pix, levels, strict=False) * d, "f32")
    red_gb = corners_in_range(pix, levels, strict=False) * 128 / 1e9
    print(f"  K5 ({label}) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]}; "
          f"dvalue reductions {red_gb:.4f} GB at {red_gb / (ms * 1e-3) / 1e3:.3f} TB/s")
    out["bwd"] = kernel_entry(max(err_v, err_a, err_l), ms, plain_ms, bound)
    return out


def phase_new_train_kernels(dev):
    """The kernels of the two new train steps at the shapes those steps give
    them: K4 and K5 at MinVIS-R50's encoder shape (4 frames, Q = S = 8064 over
    3 levels coarsest first, L * P = 12: K5's batches of 4 samples, not its
    L * P = 16 path), at SeqFormer-R50's encoder shape (4 clips x 5 frames,
    Q = S = 6800) and at its box-form decoder shape (Q = 300 per frame); K2's
    forward and backward at each step's frames (4 at 512x768, 20 at 512x640)."""
    rng = np.random.RandomState(12)
    s = sum(h * w for h, w in MINVIS_TRAIN_LEVELS)
    seq_frames = SEQ_TRAIN_CLIPS * SEQ_TRAIN_FRAMES
    minvis = msda_train_case(dev, rng, "MinVIS train encoder, 3 levels coarsest first", MINVIS_TRAIN_LEVELS,
                             2 * MINVIS_TRAIN_CLIPS, s, box=False, backward=True)
    seq_enc = msda_train_case(dev, rng, "SeqFormer train encoder", TRAIN_LEVELS, seq_frames,
                              sum(h * w for h, w in TRAIN_LEVELS), box=False, backward=True)
    seq_dec = msda_train_case(dev, rng, "SeqFormer train decoder, box form", TRAIN_LEVELS, seq_frames, 300,
                              box=True, backward=True)
    stem_minvis = stem_train_case(dev, rng, 2 * MINVIS_TRAIN_CLIPS, MINVIS_TRAIN_HW, "MinVIS train")
    stem_seq = stem_train_case(dev, rng, seq_frames, TRAIN_HW, "SeqFormer train")
    print("[phase 2b] K4 and K5 agree with their plain versions at MinVIS's train shape (L*P = 12) and at "
          "SeqFormer's encoder and box-form decoder shapes; K2's forward and backward at both steps' frames")
    return {"fwd_minvis_train": minvis["fwd"], "bwd_minvis_train": minvis["bwd"],
            "fwd_seqformer_enc": seq_enc["fwd"], "bwd_seqformer_enc": seq_enc["bwd"],
            "fwd_seqformer_dec": seq_dec["fwd"], "bwd_seqformer_dec": seq_dec["bwd"],
            "stem_minvis_train": stem_minvis, "stem_seqformer_train": stem_seq}


# ---------------------------------------------------------------- card vs CPU of a train forward
def moved(out, device):
    """A tensor, or a tuple of tensors (a ``MatchResult``), on ``device``."""
    if isinstance(out, tuple):
        parts = [moved(o, device) for o in out]
        return type(out)(*parts) if hasattr(out, "_fields") else tuple(parts)
    return out.to(device)


class AssignmentTap:
    """A model module's matching function (``assign_batched`` by default;
    IDOL's simOTA ``match`` and ``pos_neg_masks``), wrapped: it records each
    call's result (on the host) and the seconds the call took once the card
    has finished the work queued before it (its copy to the host waits for
    that work anyway: the seconds are the copy and the solve), and can replay
    recorded results instead of matching (moved to the caller's device)."""

    def __init__(self, module, name="assign_batched"):
        self.module, self.name, self.solve = module, name, getattr(module, name)
        self.recorded, self.replay, self.seconds = [], None, []

    def __call__(self, cost, *args):
        import torch

        if self.replay is not None:
            return moved(self.replay.pop(0), cost.device)
        if cost.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.solve(cost, *args)
        self.seconds.append(time.perf_counter() - t0)
        self.recorded.append(moved(out, "cpu"))
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.solve)


def train_card_vs_cpu(label, module, card, cpu, inputs_on, groups, weights, taps=("assign_batched",)):
    """One train forward and backward of ``card`` (bf16, kernels) and ``cpu``
    (f32, plain versions; the card's weights) on the same inputs: each loss
    within 5% relative, each parameter group's gradient within 10% relative L2,
    at the card's own assignment and again with the CPU's replayed on the card.
    ``module`` is the model's module (``mask2former``, ``seqformer`` or
    ``idol``) and ``taps`` its matching functions (IDOL: simOTA's ``match`` and
    the ReID ``pos_neg_masks``); a MaskFormer's sampled-loss coordinates are
    drawn once, on the CPU's run, and the card's runs take the same."""
    import torch

    from vnext_tpu_torch.models import mask2former
    from vnext_tpu_torch.ops import point_sample

    coords, replay_coords = [], []

    def sampled(src, tgt, valid, num, num_points=12544, generator=None):
        if replay_coords:
            c = replay_coords.pop(0).to(src.device)
        else:
            with torch.no_grad():
                c = point_sample.get_uncertain_point_coords_with_randomness(
                    src.detach(), num_points, torch.Generator(device=src.device).manual_seed(5 + len(coords)))
            coords.append(c.cpu())
        return point_sample.mask_losses_at(src, tgt, c, valid, num)

    def run(model, device, replay=None):
        model.zero_grad(set_to_none=True)
        replay_coords[:] = coords
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(mask2former, "sampled_mask_losses", sampled))
            tapped = [stack.enter_context(AssignmentTap(module, name)) for name in taps]
            for i, tap in enumerate(tapped):
                tap.replay = None if replay is None else list(replay[i])
            losses = model(*inputs_on(device))
            total = sum(losses[k] * weights[k] for k in losses if k in weights)
            total.backward()
        grads = {}
        for group, prefixes in groups:
            gs = [p.grad.detach().float().cpu().reshape(-1) for n, p in model.named_parameters()
                  if n.startswith(prefixes) and p.grad is not None]
            grads[group] = torch.cat(gs)
        return {k: float(v.detach()) for k, v in losses.items()}, grads, [tap.recorded for tap in tapped]

    t0 = time.perf_counter()
    want_losses, want_grads, cpu_assign = run(cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    got_losses, got_grads, card_assign = run(card, "card")
    # the first tap's first field: an assignment's gt slot per query, simOTA's selected queries
    first = [(a[0] if isinstance(a, tuple) else a, b[0] if isinstance(b, tuple) else b)
             for a, b in zip(card_assign[0], cpu_assign[0])]
    differ = sum(int((a != b).sum()) for a, b in first)
    total = sum(int((b >= 0).sum()) if b.dtype != torch.bool else int(b.sum()) for _, b in first)
    print(f"  {label}: CPU f32 forward + backward {cpu_s:.1f} s; the card's matching differs from the CPU's in "
          f"{differ} of {total} assigned entries (bf16 outputs beside f32 ones)")
    forced_losses, forced_grads, _ = run(card, "card", replay=cpu_assign)
    reason = ("bf16 keeps 8 significant bits, and the forward and backward round ~100 times in sequence, so "
              "errors that add like a random walk reach a few percent")
    result = {"assignments_differing": differ, "assigned": total, "cpu_s": cpu_s}
    for tag, losses, grads in (("own", got_losses, got_grads), ("cpu_assignment", forced_losses, forced_grads)):
        loss_err = {k: abs(losses[k] - v) / max(abs(v), 1e-6) for k, v in want_losses.items()}
        grad_err = {g: float((grads[g] - want_grads[g]).norm() / want_grads[g].norm().clamp_min(1e-30))
                    for g in want_grads}
        worst = max(loss_err, key=loss_err.get)
        where = "its own assignment" if tag == "own" else "the CPU's assignment"
        print(f"  {label}, card at {where}: losses relative "
              f"error max {loss_err[worst]:.4g} ({worst}) tolerance 0.05; gradients relative L2 "
              + ", ".join(f"{g} {e:.4g}" for g, e in grad_err.items()) + f" tolerance 0.10: {reason}")
        result[tag] = {"loss_rel_err": loss_err, "grad_rel_l2": grad_err}
        if tag == "cpu_assignment" or differ == 0:
            for k, e in loss_err.items():
                require(e <= 0.05, f"{label} ({tag}): {k} relative error {e}")
            for g, e in grad_err.items():
                require(e <= 0.10, f"{label} ({tag}): gradient of {g} relative L2 {e}")
    return result


MINVIS_GROUPS = (
    ("backbone", ("backbone.",)),
    ("pixel decoder", ("pixel_decoder.",)),
    ("masked decoder", ("transformer_decoder.",)),
)
SEQ_GROUPS = (
    ("backbone", ("backbone.",)),
    ("input projections", ("input_proj_",)),
    ("encoder", ("transformer.encoder_", "transformer.level_embed")),
    ("decoder", ("transformer.decoder_", "transformer.reference_points", "transformer.bbox_embed_",
                 "query_embed")),
    ("heads", ("class_embed_", "controller.", "mask_head.")),
)


# ---------------------------------------------------------------- phase 18
MINVIS_DATASET = "ovis_synthetic_entry_point"
MINVIS_TRAIN_STEPS, MINVIS_RESUME_STEPS = 4, 6


def phase_minvis_entry(dev, kernels, smi):
    """MinVIS-R50 through the port's ``train_net_video.main``, in-process, on a
    synthetic OVIS-category dataset: ``--eval-only`` in windows of 3, the ground
    truth through the evaluator, training with periodic checkpoints,
    ``--resume``, the motion config's ``ValueError``; then one clip's train
    forward on the card against the CPU."""
    import torch

    from vnext_tpu_torch.checkpoint.checkpointer import Checkpointer
    from vnext_tpu_torch.data import OVIS_CLASSES, DatasetCatalog
    from vnext_tpu_torch.evaluation.ytvis_eval import YTVISEvaluator
    from vnext_tpu_torch.models import mask2former
    from vnext_tpu_torch.tools import train_net_video as tv

    t_phase = time.perf_counter()
    result = {}
    configs = Path(__file__).resolve().parent / "configs" / "minvis"
    with tempfile.TemporaryDirectory() as tmp:
        register_synthetic(f"{tmp}/data", MINVIS_DATASET, OVIS_CLASSES)
        records = DatasetCatalog.get(MINVIS_DATASET)
        common = ["--config-file", str(configs / "ovis_r50.yaml"), "DATASETS.TEST", f"('{MINVIS_DATASET}',)",
                  "DATASETS.TRAIN", f"('{MINVIS_DATASET}',)"]

        # ---- --eval-only
        video_ms, evaluate_s, build_evaluator = [], [], tv.build_evaluator

        class TimedRunner(tv.MinVISVideoInference):
            def __call__(self, record):
                t1 = time.perf_counter()
                out = super().__call__(record)
                video_ms.append((time.perf_counter() - t1) * 1e3)
                return out

        def timed_evaluator(cfg, name, output_dir=None):
            ev = build_evaluator(cfg, name, output_dir)
            evaluate = ev.evaluate

            def timed():
                t1 = time.perf_counter()
                out = evaluate()
                evaluate_s.append(time.perf_counter() - t1)
                return out

            ev.evaluate = timed
            return ev

        eval_dir = f"{tmp}/eval"
        zero(kernels)
        with patched(tv, "MinVISVideoInference", TimedRunner), patched(tv, "build_evaluator", timed_evaluator):
            results = tv.main(["--eval-only", *common, "OUTPUT_DIR", eval_dir])
        torch.cuda.synchronize()
        eval_launches = counts(kernels)
        n_windows = len(records) * -(-VIDEO_FRAMES[0] // MINVIS_WINDOW)
        expected = {"stem_conv": n_windows, "ms_deform_attn_fwd": 6 * n_windows, "encoder_epilogue": 6 * n_windows}
        print(f"  --eval-only: launches over {n_windows} windows of {MINVIS_WINDOW} {eval_launches} "
              f"(expected {expected}: per window K2 / K1 / K3 = 1 / 6 / 6)")
        require(eval_launches == expected, f"MinVIS eval launch counts {eval_launches} != {expected}")
        with open(f"{eval_dir}/results.json") as f:
            entries = json.load(f)
        require(len(entries) == 10 * len(records), f"{len(entries)} entries: MinVIS keeps 10 a video")
        for e in entries:
            require(1 <= e["category_id"] <= MINVIS_CLASSES and 0.0 <= e["score"] <= 1.0, f"bad entry {e['score']}")
            require(len(e["segmentations"]) == VIDEO_FRAMES[0] and all(
                sg["size"] == list(VIDEO_HW) for sg in e["segmentations"]), "one 480x853 RLE per frame")
        stats = results[MINVIS_DATASET]["segm"]
        check_stats(stats, "MinVIS --eval-only")
        print(f"  --eval-only: {len(entries)} results.json entries; AP dict {stats}; per video "
              f"{', '.join(f'{v:.1f}' for v in video_ms)} ms through do_eval (decode, windows, matching, top 10, "
              f"masks at 480x853; seeded weights); the evaluator {evaluate_s[0]:.3f} s")
        result["eval"] = {"video_ms": list(video_ms), "evaluator_s": evaluate_s[0], "entries": len(entries),
                          "stats": stats, "launches": eval_launches, "windows": n_windows}

        ev = YTVISEvaluator(MINVIS_DATASET, output_dir=f"{tmp}/gt")
        ev.reset()
        for rec, out in zip(records, ground_truth_outputs(records)):
            ev.process([rec], [out])
        gt_stats = ev.evaluate()["segm"]
        require(gt_stats["AP"] == 1.0, f"the ground truth scored AP {gt_stats['AP']}, not 1.0")
        print(f"  the ground truth as predictions through YTVISEvaluator on the OVIS-category json: {gt_stats}")
        result["ground_truth_stats"] = gt_stats
        torch.cuda.empty_cache()

        # ---- training and --resume
        train_dir = f"{tmp}/train"
        train = [*common, "OUTPUT_DIR", train_dir, "SOLVER.IMS_PER_BATCH", str(MINVIS_TRAIN_CLIPS),
                 "SOLVER.CHECKPOINT_PERIOD", "2"]
        step_starts, waits, eval_deltas, saves = [], [], [], []
        do_eval, build_loader, save = tv.do_eval, tv.build_vis_train_loader, Checkpointer.save
        resume_or_load, loaded = Checkpointer.resume_or_load, {}

        class TimedTrainer(tv.VISTrainer):
            def run_step(self):
                step_starts.append(time.perf_counter())
                super().run_step()

        def timed_loader(*a, **k):
            it = build_loader(*a, **k)

            def gen():
                while True:
                    t1 = time.perf_counter()
                    batch = next(it)
                    waits.append((time.perf_counter() - t1) * 1e3)
                    yield batch

            return gen()

        def counted_eval(cfg, model=None):
            before = counts(kernels)
            out = do_eval(cfg, model)
            torch.cuda.synchronize()
            eval_deltas.append(minus(counts(kernels), before))
            return out

        def timed_save(self, name, state):
            t1 = time.perf_counter()
            path = save(self, name, state)
            saves.append((t1, time.perf_counter(), os.path.getsize(path)))
            return path

        def checked_resume(self, weights_path, state, resume=True):
            path = self.get_checkpoint_file()
            state, start = resume_or_load(self, weights_path, state, resume)
            if resume:
                saved = torch.load(path, map_location="cpu", weights_only=True)
                loaded.update(path=path, start=start, model=all(torch.equal(v.cpu(), saved["model"][k])
                                                                for k, v in state.model.state_dict().items()),
                              optimizer=same_optimizer_state(state.optimizer.state_dict(), saved["optimizer"]),
                              scheduler=state.scheduler.state_dict() == saved["scheduler"])
            return state, start

        runs = {}
        for label, argv, steps in (("train", [*train, "SOLVER.MAX_ITER", str(MINVIS_TRAIN_STEPS)], MINVIS_TRAIN_STEPS),
                                   ("resume", ["--resume", *train, "SOLVER.MAX_ITER", str(MINVIS_RESUME_STEPS)],
                                    MINVIS_RESUME_STEPS)):
            step_starts.clear()
            waits.clear()
            eval_deltas.clear()
            tap = AssignmentTap(mask2former)
            zero(kernels)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            with patched(tv, "VISTrainer", TimedTrainer), patched(tv, "build_vis_train_loader", timed_loader), \
                    patched(tv, "do_eval", counted_eval), tap, \
                    patched(Checkpointer, "save", timed_save), patched(Checkpointer, "resume_or_load", checked_resume):
                trainer = tv.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            require(len(eval_deltas) == 1, f"MinVIS {label}: {len(eval_deltas)} evaluations")
            in_train = minus(counts(kernels), eval_deltas[0])
            n = steps - trainer.start_iter
            want = {"ms_deform_attn_v9_fwd": 6 * n, "ms_deform_attn_v9_bwd": 6 * n, "stem_conv": n}
            print(f"  {label}: iterations {trainer.start_iter}..{trainer.iter - 1}; launches in the train steps "
                  f"{in_train} (expected {want}: per step the pixel decoder's 6 layers through K4 and K5, one stem "
                  f"over the {2 * MINVIS_TRAIN_CLIPS} frames), in the evaluation after training {eval_deltas[0]}")
            require(in_train == want, f"MinVIS {label}: train launch counts {in_train} != {want}")
            require(eval_deltas[0] == expected, f"MinVIS {label}: evaluation launches {eval_deltas[0]} != {expected}")
            hist = trainer.storage.histories()
            keys = sorted(k for k in hist if k.startswith("loss_"))
            require(len(keys) == 3 * 10, f"MinVIS {label}: loss keys {keys}")
            for k in keys + ["total_loss"]:
                require(hist[k].count() == n and np.isfinite(hist[k].values()).all(), f"{label} {k}")
            marker = Path(f"{train_dir}/last_checkpoint").read_text()
            require(marker == f"model_{steps - 1:07d}.pth", f"MinVIS {label}: last_checkpoint names {marker}")
            periods = [(b - a - sum(e - s for s, e, _ in saves if a <= s < b)) * 1e3
                       for a, b in zip(step_starts, step_starts[1:])]
            # the training steps' matchings: the calls before the evaluation's none (eval has no matching)
            assign_s = [v * 1e3 for v in tap.seconds]
            runs[label] = {"iterations": [trainer.start_iter, trainer.iter], "launches": in_train,
                           "step_period_ms": periods, "loader_wait_ms": list(waits), "assignment_host_ms": assign_s,
                           "total_loss": hist["total_loss"].values(), "peak_memory_gb": peak_gb, "wall_s": wall}
            print(f"  {label}: total_loss {', '.join(f'{v:.3f}' for v in hist['total_loss'].values())}; step period "
                  f"through the entry point (host clock between step starts, less a save) "
                  f"{', '.join(f'{v:.1f}' for v in periods)} ms; next(loader) blocked "
                  f"{', '.join(f'{v:.1f}' for v in waits)} ms; the assignment (one copy of 10 predictions x "
                  f"{2 * MINVIS_TRAIN_CLIPS} frames of [48, 100] costs to the host, scipy) "
                  f"{', '.join(f'{v:.1f}' for v in assign_s)} ms a step; peak memory {peak_gb:.2f} GiB; {wall:.1f} s")
            del trainer
            torch.cuda.empty_cache()
        require(loaded.get("start") == MINVIS_TRAIN_STEPS, f"MinVIS --resume started at {loaded.get('start')}")
        require(loaded["model"] and loaded["optimizer"] and loaded["scheduler"],
                f"MinVIS --resume: restored state differs from {loaded['path']}")
        print(f"  --resume from {Path(loaded['path']).name}: started at iteration {loaded['start']}; model, optimizer "
              f"and scheduler state equal to the file bit for bit; checkpoints {saves[-1][2] / 2 ** 20:.1f} MiB, "
              f"saved in {', '.join(f'{e - s:.2f}' for s, e, _ in saves)} s")
        result.update(train=runs["train"], resume=runs["resume"], checkpoint_mib=saves[-1][2] / 2 ** 20)

        # ---- the motion config at the runner's 480x864: 120x216 masks
        try:
            tv.main(["--eval-only", "--config-file", str(configs / "ovis_r50_motion.yaml"), *common[2:],
                     "OUTPUT_DIR", f"{tmp}/motion"])
        except ValueError as e:
            require("120x216" in str(e), f"the motion config raised another ValueError: {e}")
            print(f"  ovis_r50_motion.yaml --eval-only raised before any video, as in the JAX package: {e}")
        else:
            require(False, "ovis_r50_motion.yaml --eval-only ran at 120x216 masks")
    torch.cuda.empty_cache()

    # ---- one clip's train forward, card vs CPU
    cfg = read_config("minvis/ovis_r50.yaml")
    card = mask2former.build_maskformer_model(cfg, device=dev, seed=3).train()
    cpu = mask2former.build_maskformer_model(cfg, device="cpu", dtype=torch.float32, seed=4).train()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = synthetic_batch(np.random.RandomState(18), n_clips=1, hw=MINVIS_TRAIN_HW, n_classes=MINVIS_CLASSES)
    adapters = {"card": tv.minvis_batch_adapter(cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, dev),
                "cpu": tv.minvis_batch_adapter(cfg.MODEL.PIXEL_MEAN, cfg.MODEL.PIXEL_STD, "cpu")}
    result["card_vs_cpu"] = train_card_vs_cpu(
        "MinVIS train forward (one clip, key + reference at 512x768)", mask2former, card, cpu,
        lambda d: adapters[d](batch), MINVIS_GROUPS, mask2former.maskformer_weight_dict(cfg))
    del card, cpu
    torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"  {smi}")
    print(f"[phase 18] MinVIS through train_net_video: --eval-only K2 / K1 / K3 = 1 / 6 / 6 per window, the ground "
          f"truth AP 1.0, training and --resume through K4 / K5 / K2 = 6 / 6 / 1 per step, the state restored bit "
          f"for bit, the motion config refused; card agrees with CPU; {result['phase_s']:.1f} s")
    return {"minvis_entry_eval": eval_launches, "minvis_entry_train": runs["train"]["launches"]}, result


# ---------------------------------------------------------------- phase 19
def seqformer_clip_batch(rng, n_clips, dev, pixel_mean, pixel_std, hw=TRAIN_HW):
    """Seeded synthetic clips for SeqFormer's train forward: frames [B, 5, 512,
    640, 3] (``hw``; normalized f32) with coloured rectangles drifting over the
    clip, valid sizes [B, 2], and ``ClipTargets`` of 8..24 instances a clip
    (boxes cxcywh per frame, stride-4 masks; a few absent on a frame)."""
    import torch

    from vnext_tpu_torch.models.seqformer import ClipTargets

    h, w = hw
    nf, k = SEQ_TRAIN_FRAMES, SEQ_MAX_INSTS
    images = rng.randint(0, 50, (n_clips, nf, h, w, 3)).astype(np.uint8)
    boxes = np.zeros((n_clips, k, nf, 4), np.float32)
    masks = np.zeros((n_clips, k, nf, h // 4, w // 4), bool)
    n_inst = rng.randint(8, k + 1, size=n_clips)
    valid = np.arange(k)[None] < n_inst[:, None]
    labels = rng.randint(0, 40, (n_clips, k)).astype(np.int32)
    for i in range(n_clips):
        for j in np.flatnonzero(valid[i]):
            c0, v = rng.rand(2) * 0.6 + 0.2, (rng.rand(2) - 0.5) * 0.04
            ext = rng.rand(2) * 0.25 + 0.05
            colour = rng.randint(0, 256, 3)
            for f in range(nf):
                if f > 0 and rng.rand() < 0.05:
                    continue                                    # absent on this frame
                c = c0 + v * f
                x0, x1 = ((c[0] + np.array([-0.5, 0.5]) * ext[0]) * w).clip(0, w).astype(int)
                y0, y1 = ((c[1] + np.array([-0.5, 0.5]) * ext[1]) * h).clip(0, h).astype(int)
                images[i, f, y0:y1, x0:x1] = colour
                masks[i, j, f, y0 // 4:y1 // 4 + 1, x0 // 4:x1 // 4 + 1] = True
                boxes[i, j, f] = [c[0], c[1], ext[0], ext[1]]
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=dev)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=dev)
    x = (torch.from_numpy(images).to(dev).float() - mean) / std
    sizes = torch.tensor([[h, w]] * n_clips, dtype=torch.int32, device=dev)
    targets = ClipTargets(*(torch.from_numpy(a).to(dev) for a in (labels, boxes, masks, valid)))
    return x, sizes, targets


def check_update_landed(model, optimizer, before, lrs):
    """Hold an AdamW run's update of ``model`` against the parameters
    ``before`` it and each step's learning rate by group (``lrs``): frozen
    parameters stayed bit-equal; each trainable one was reached by the steps'
    gradients (a non-zero first moment), moved no further than AdamW allows
    (|m_hat / sqrt(v_hat)| <= 1.004 a step for any gradients over 3 steps at
    betas (0.9, 0.999), by Cauchy-Schwarz, plus the decoupled decay and an ulp
    of rounding a step), and moved wherever the last step's update was at
    least 4 ulps of an element: the warm-up's first updates (lr ~1e-7, ~1e-8
    in the backbone) round away on the larger elements. Returns the counts of
    frozen parameters, of trainable ones that moved, and of trainable ones
    with an element the last update had to move."""
    import torch

    from vnext_tpu_torch.solver import build as solver

    group_of = {id(p): i for i, g in enumerate(optimizer.param_groups) for p in g["params"]}
    unreached, too_far, stuck, frozen_moved = [], [], [], []
    frozen = moved = landable = 0
    for n, p in model.named_parameters():
        old = before[n].float()
        if solver.is_frozen(n):
            frozen += 1
            frozen_moved += [] if torch.equal(p.detach(), before[n]) else [n]
            continue
        moved += not torch.equal(p.detach(), before[n])
        st = optimizer.state.get(p, {})
        if "exp_avg" not in st or not bool(st["exp_avg"].abs().max() > 0):
            unreached.append(n)
            continue
        gi = group_of[id(p)]
        group, ulp = optimizer.param_groups[gi], torch.finfo(p.dtype).eps
        (beta1, beta2), t = group["betas"], float(st["step"])
        delta = (p.detach().float() - old).abs()
        limit = sum(lr[gi] for lr in lrs) * (1.01 + group["weight_decay"] * old.abs()) + len(lrs) * ulp * old.abs()
        too_far += [n] if bool((delta > limit).any()) else []
        last = lrs[-1][gi] * (st["exp_avg"] / (1 - beta1 ** t)) / (
            (st["exp_avg_sq"] / (1 - beta2 ** t)).sqrt() + group["eps"])
        lands = last.abs() >= 4 * ulp * old.abs()
        if bool(lands.any()):
            landable += 1
            stuck += [] if bool((delta[lands] > 0).any()) else [n]
    require(not unreached, f"trainable parameters no gradient reached: {unreached[:10]}")
    require(not too_far, f"trainable parameters that moved further than AdamW's steps allow: {too_far[:10]}")
    require(not stuck, f"trainable parameters whose update did not land: {stuck[:10]}")
    require(not frozen_moved, f"frozen parameters that moved: {frozen_moved[:10]}")
    return frozen, moved, landable


def measured_train_steps(label, dev, kernels, model, optimizer, state, step, inputs, weights, clip, want, n_loss_keys,
                         taps=()):
    """``step`` over ``inputs`` (one batch a step), each step synchronized and
    timed with its launch counts (each must equal ``want``), losses finite and
    ``n_loss_keys`` of them named ``loss_*`` (deep supervision's layers), then
    ``check_update_landed``; the step's forward / backward / update split (the
    faster of 2, synchronized) and one profiled step's device busy time. ``taps``
    are ``AssignmentTap``s over the steps (their host seconds are reported)."""
    import torch

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vnext_tpu_torch.engine.train_step import dropout_generator

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step_ms, per_step, lrs = [], [], []       # lrs: each step's learning rate by parameter group
    torch.cuda.reset_peak_memory_stats(dev)
    with contextlib.ExitStack() as stack:
        for tap in taps:
            stack.enter_context(tap)
        for x in inputs:
            lrs.append([g["lr"] for g in optimizer.param_groups])
            zero(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, x)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append(counts(kernels))
            losses = {k: float(v) for k, v in metrics.items()}
            require(all(np.isfinite(v) for v in losses.values()), f"{label} losses {losses}")
            loss_keys = sorted(k for k in losses if k.startswith("loss_"))
            require(len(loss_keys) == n_loss_keys, f"{label}: {len(loss_keys)} loss keys, not {n_loss_keys}: "
                                                   f"{loss_keys}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"  launches per step {per_step} (expected {want})")
    require(all(c == want for c in per_step), f"{label} train launch counts {per_step} != {want}")
    frozen, moved, landable = check_update_landed(model, optimizer, before, lrs)
    del before
    n_trainable = len(list(model.parameters())) - frozen
    host = "".join(f"; {tap.name} on the host {', '.join(f'{v * 1e3:.1f}' for v in tap.seconds)} ms" for tap in taps)
    print(f"  {len(inputs)} steps, every loss finite and {n_loss_keys} loss_* keys a step (total "
          f"{losses['total_loss']:.4f} at the last); every one of "
          f"{n_trainable} trainable parameters reached by a gradient (AdamW's first moment non-zero) and within "
          f"AdamW's reach; {landable} of them have elements the last update (lr "
          f"{', '.join(f'{v:.3g}' for v in lrs[-1])} by group) moves by 4 ulps or more, and each of those moved; "
          f"{moved} moved in all; {frozen} frozen ones bit-equal; step ms (synchronized) "
          f"{', '.join(f'{v:.1f}' for v in step_ms)}{host}; peak memory {peak_gb:.2f} GiB")

    params = list(model.parameters())
    parts = {"forward": [], "backward": [], "update": []}
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = model(*inputs[0], generator=dropout_generator(0, 100 + i, dev))
        total = sum(losses[k] * weights[k] for k in losses if k in weights)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.zero_grad(set_to_none=True)
        total.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        clip(params)
        optimizer.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(v * 1e3)
    split = {k: min(v) for k, v in parts.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = model(*inputs[1], generator=dropout_generator(0, 200, dev))
        total = sum(losses[k] * weights[k] for k in losses if k in weights)
        model.zero_grad(set_to_none=True)
        total.backward()
        clip(params)
        optimizer.step()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: -e.self_device_time_total)
    print(f"  step split (the faster of 2, synchronized): forward {split['forward']:.1f} ms, backward "
          f"{split['backward']:.1f} ms, clip + AdamW {split['update']:.1f} ms; torch.profiler over one step: device "
          f"busy {busy:.1f} ms of {prof_wall:.1f} ms wall ({busy / prof_wall:.1%}); top kernels, ms per step:")
    print_kernel_rows(events, 1, 10)
    return {"step_ms": step_ms, "forward_ms": split["forward"], "backward_ms": split["backward"],
            "update_ms": split["update"], "device_busy_ms": busy, "profiled_step_ms": prof_wall,
            "peak_memory_gb": peak_gb, "launches_per_step": per_step, "trainable_moved": moved,
            **{f"{tap.name}_host_ms": [v * 1e3 for v in tap.seconds] for tap in taps}}


class DropPathTap:
    """Swin's ``drop_path_mask``, wrapped: it records each draw's keep
    probability and mask (left on the device)."""

    def __init__(self):
        from vnext_tpu_torch.models.backbones import swin

        self.swin, self.draw, self.draws = swin, swin.drop_path_mask, []

    def __call__(self, n, keep, generator, device):
        mask = self.draw(n, keep, generator, device)
        self.draws.append((keep, mask))
        return mask

    def __enter__(self):
        self.swin.drop_path_mask = self
        return self

    def __exit__(self, *exc):
        self.swin.drop_path_mask = self.draw


def check_drop_path(model, draws, label):
    """Every Swin block but the first has its rate from
    ``linspace(0, DROP_PATH_RATE, sum(depths))``, and over the steps' draws the
    kept share of each block sits within 4 sigma of its keep probability (the
    blocks' rates differ, so a draw's probability names its block)."""
    import torch

    from vnext_tpu_torch.models.backbones.swin import SwinBlock

    rates = [m.drop_path for m in model.backbone.modules() if isinstance(m, SwinBlock)]
    want = np.linspace(0, model.backbone.drop_path_rate, len(rates)).tolist()
    require(rates == want, f"{label}: block rates {rates} != {want}")
    by_block = {}
    for keep, mask in draws:
        by_block.setdefault(keep, []).append(mask.flatten())
    require(len(by_block) == len(rates) - 1, f"{label}: {len(by_block)} blocks drew, not {len(rates) - 1}")
    z = {}
    for keep, masks in by_block.items():
        kept = torch.cat(masks).float()
        share = float(kept.mean())
        z[keep] = abs(share - keep) / (keep * (1 - keep) / kept.numel()) ** 0.5
        require(z[keep] <= 4.0, f"{label}: a block of keep {keep:.4f} kept {share:.4f} of {kept.numel()} samples")
    n = sum(m.numel() for m in by_block[max(by_block)])
    print(f"  drop-path: {len(rates)} blocks at rates 0 .. {want[-1]:.2f} (linspace), the first drawing nothing; "
          f"{len(draws)} draws, {n} samples a block; kept share within {max(z.values()):.2f} sigma of 1 - rate at "
          f"worst (limit 4)")
    return {"blocks_drawing": len(by_block), "samples_per_block": n, "max_sigma": max(z.values())}


def check_draws_repeat(model, inputs, dev, label):
    """Two train forwards with the generator of one (seed, step) draw the same
    drop-path masks bit for bit."""
    import torch

    from vnext_tpu_torch.engine.train_step import dropout_generator

    runs = []
    for _ in range(2):
        with torch.no_grad(), DropPathTap() as tap:
            model(*inputs, generator=dropout_generator(0, 7, dev))
        runs.append([m for _, m in tap.draws])
    require(len(runs[0]) == len(runs[1]) > 0 and all(torch.equal(a, b) for a, b in zip(*runs)),
            f"{label}: two draws from one (seed, step) differ")
    print(f"  drop-path: two forwards from the generator of one (seed, step) drew the same {len(runs[0])} masks")


def phase_seqformer_train(dev, kernels, smi, config="seqformer/ytvis19_r50.yaml", label="SeqFormer-R50", tag="19",
                          n_clips=SEQ_TRAIN_CLIPS, cpu_hw=TRAIN_HW, path="seqformer_train"):
    """SeqFormer's clip-level train step at its config's width through
    ``make_train_step``: ``n_clips`` clips x 5 frames at 512x640 a step, 3
    steps, then the step's parts, the device's busy time, and one clip (at
    ``cpu_hw``) train forward on the card against the CPU. For Swin-L, also
    drop-path's rates and draws."""
    import torch

    from vnext_tpu_torch.engine.train_step import TrainState, make_train_step
    from vnext_tpu_torch.models import seqformer
    from vnext_tpu_torch.models.layers import init_weights
    from vnext_tpu_torch.solver import build as solver

    t_phase = time.perf_counter()
    cfg = read_config(config)
    model = seqformer.build_seqformer_model(cfg, device=dev, seed=0).train()
    describe(model, f"{label} for training", config, t_phase)
    swin = "swin" in cfg.MODEL.BACKBONE.NAME.lower()          # as backbone_kwargs_from_cfg selects Swin
    optimizer = solver.build_optimizer(cfg, model)
    state = TrainState.create(model, optimizer, solver.build_lr_scheduler(cfg, optimizer))
    weights = seqformer.seqformer_weight_dict(cfg)
    clip = solver.build_grad_clip(cfg)
    step = make_train_step(model, optimizer, weights, clip)
    mean, std = tuple(cfg.MODEL.PIXEL_MEAN), tuple(cfg.MODEL.PIXEL_STD)
    inputs = [seqformer_clip_batch(np.random.RandomState(190 + i), n_clips, dev, mean, std)
              for i in range(SEQ_TRAIN_STEPS)]
    print(f"  batches: {n_clips} clips x {SEQ_TRAIN_FRAMES} frames at {TRAIN_HW[0]}x{TRAIN_HW[1]}, instances "
          f"per clip {[int(v) for v in inputs[0][2].valid.sum(1)]} (first batch), up to {SEQ_MAX_INSTS}")
    want = {"ms_deform_attn_v9_fwd": 12, "ms_deform_attn_v9_bwd": 12, **({} if swin else {"stem_conv": 1})}
    print(f"  expected launches a step: {want} (6 encoder and 6 decoder MSDA layers over the "
          f"{n_clips * SEQ_TRAIN_FRAMES} frames, forward and backward{'' if swin else ', one stem'})")
    with DropPathTap() as drops:
        result = measured_train_steps(label, dev, kernels, model, optimizer, state, step, inputs, weights, clip,
                                      want, 5 * model.dec_layers, taps=(AssignmentTap(seqformer),))
    if swin:
        result["drop_path"] = check_drop_path(model, drops.draws, label)
        check_draws_repeat(model, inputs[0], dev, label)
    else:
        require(not drops.draws, f"{label}: a ResNet drew drop-path masks")
    per_step = result["launches_per_step"]
    del model, state, optimizer, step, inputs, drops
    torch.cuda.empty_cache()

    # ---- one clip, card vs CPU, dropout 0 (and drop-path 0)
    kwargs = {**seqformer.seqformer_kwargs_from_cfg(cfg), "dropout": 0.0}
    if swin:
        kwargs["swin"] = kwargs["swin"][:4] + (0.0,)
    card = seqformer.SeqFormer(**kwargs)
    init_weights(card, 3)
    card = card.to(dev).train()
    cpu = seqformer.SeqFormer(**{**kwargs, "dtype": torch.float32}).train()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    clip_inputs = seqformer_clip_batch(np.random.RandomState(19), 1, "cpu", mean, std, hw=cpu_hw)

    def on(device):
        x, sizes, t = clip_inputs
        if device == "cpu":
            return x, sizes, t
        return x.to(dev), sizes.to(dev), type(t)(*(a.to(dev) for a in t))

    result["card_vs_cpu"] = train_card_vs_cpu(
        f"{label} train forward (one clip of {SEQ_TRAIN_FRAMES} frames at {cpu_hw[0]}x{cpu_hw[1]})", seqformer, card,
        cpu, on, SEQ_GROUPS, weights)
    del card, cpu
    torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"  {smi}")
    print(f"[phase {tag}] {label}'s train step ran {SEQ_TRAIN_STEPS} steps of {n_clips} clips through "
          f"{' / '.join(f'{k} {v}' for k, v in want.items())} a step; losses finite; trainable reached and landed "
          f"({result['trainable_moved']} moved), frozen stayed; card agrees with CPU; {result['phase_s']:.1f} s")
    return {path: {k: sum(c.get(k, 0) for c in per_step) for k in per_step[0]}}, result


def phase_seqformer_swin_train(dev, kernels, smi):
    """Phase 21: phase 19 on SeqFormer-Swin-L (configs/seqformer/swin_ytvis.yaml),
    drop-path 0.3, card vs CPU on one clip of 5 frames at 384x480."""
    return phase_seqformer_train(dev, kernels, smi, "seqformer/swin_ytvis.yaml", "SeqFormer-Swin-L", "21",
                                 SEQ_SWIN_TRAIN_CLIPS, SEQ_SWIN_CPU_HW, "seqformer_swinl_train")


# ---------------------------------------------------------------- phase 20
SWIN_TRAIN_CLIPS, SWIN_TRAIN_STEPS = 4, 3
# SeqFormer-Swin-L: 2 clips x 5 frames a step (4 clips ran out of the card's 80 GB in the first step's
# forward, with 78.19 GiB allocated: NVIDIA H100 80GB HBM3, 700 W); its card-vs-CPU clip at 384x480 keeps
# the CPU's f32 forward and backward of 5 Swin-L frames near a minute
SEQ_SWIN_TRAIN_CLIPS, SEQ_SWIN_CPU_HW = 2, (384, 480)
SWIN_ENTRY_DATASET, SWIN_ENTRY_FRAMES = "ytvis_synthetic_swin_entry", 6
IDOL_GROUPS = SEQ_GROUPS[:4] + (("heads", ("class_embed_", "controller.", "mask_head.", "reid_embed.")),)


def idol_weight_dict(cfg):
    """The entry point's loss weights for IDOL (``tools/train_net.do_train``'s)."""
    from vnext_tpu_torch.models.criterion import default_weight_dict

    c = cfg.MODEL.IDOL
    return default_weight_dict(class_weight=c.CLASS_WEIGHT, l1_weight=c.L1_WEIGHT, giou_weight=c.GIOU_WEIGHT,
                               mask_weight=c.MASK_WEIGHT, dice_weight=c.DICE_WEIGHT, reid_weight=c.REID_WEIGHT,
                               dec_layers=c.DEC_LAYERS, deep_supervision=c.DEEP_SUPERVISION)


def phase_idol_swin_train(dev, kernels, smi):
    """IDOL-Swin-L training at full width: 3 steps of 4 clips (key + reference
    at 512x640) through ``make_train_step`` at drop-path 0.3, the step's parts,
    busy share and peak memory; drop-path's rates and draws on the card; one
    clip card vs CPU at drop-path 0 and dropout 0; then ``train_net`` on a
    synthetic dataset with ``--resume``."""
    import torch

    from vnext_tpu_torch.checkpoint.checkpointer import Checkpointer
    from vnext_tpu_torch.data.datasets.ytvis import YTVIS_2019_CLASSES
    from vnext_tpu_torch.engine.train_step import TrainState, make_train_step
    from vnext_tpu_torch.engine.trainer import PIXEL_MEAN, PIXEL_STD, batch_to_model_inputs
    from vnext_tpu_torch.models import idol
    from vnext_tpu_torch.models.layers import init_weights
    from vnext_tpu_torch.solver import build as solver
    from vnext_tpu_torch.tools import train_net

    t_phase = time.perf_counter()
    config = "idol/ytvis19_swinL.yaml"
    cfg = read_config(config)
    model = idol.build_idol_model(cfg, device=dev, seed=0).train()
    describe(model, "IDOL-Swin-L for training", config, t_phase)
    optimizer = solver.build_optimizer(cfg, model)
    state = TrainState.create(model, optimizer, solver.build_lr_scheduler(cfg, optimizer))
    weights, clip = idol_weight_dict(cfg), solver.build_grad_clip(cfg)
    step = make_train_step(model, optimizer, weights, clip)
    inputs = [batch_to_model_inputs(synthetic_batch(np.random.RandomState(200 + i), n_clips=SWIN_TRAIN_CLIPS),
                                    PIXEL_MEAN, PIXEL_STD, dev) for i in range(SWIN_TRAIN_STEPS)]
    want = {"ms_deform_attn_v9_fwd": 24, "ms_deform_attn_v9_bwd": 24}
    print(f"  batches: {SWIN_TRAIN_CLIPS} clips of key + reference at {TRAIN_HW[0]}x{TRAIN_HW[1]}, up to "
          f"{MAX_INSTS} instances; expected launches a step {want} (6 encoder and 6 decoder MSDA layers on the key "
          f"and on the reference frames, forward and backward; a patch embed, no stem)")
    with DropPathTap() as drops:
        result = measured_train_steps("IDOL-Swin-L", dev, kernels, model, optimizer, state, step, inputs, weights,
                                      clip, want, 5 * model.dec_layers + 2)
    result["drop_path"] = check_drop_path(model, drops.draws, "IDOL-Swin-L")
    check_draws_repeat(model, inputs[0], dev, "IDOL-Swin-L")
    per_step = result["launches_per_step"]
    del model, state, optimizer, step, inputs, drops
    torch.cuda.empty_cache()

    # ---- one clip, card vs CPU, drop-path 0 and dropout 0, the CPU's matching replayed on the card
    kwargs = {**idol.idol_kwargs_from_cfg(cfg), "dropout": 0.0}
    kwargs["swin"] = kwargs["swin"][:4] + (0.0,)
    card = idol.IDOL(**kwargs)
    init_weights(card, 3)
    card = card.to(dev).train()
    cpu = idol.IDOL(**{**kwargs, "dtype": torch.float32}).train()
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = synthetic_batch(np.random.RandomState(20), n_clips=1)
    result["card_vs_cpu"] = train_card_vs_cpu(
        "IDOL-Swin-L train forward (one clip, key + reference at 512x640)", idol, card, cpu,
        lambda d: batch_to_model_inputs(batch, PIXEL_MEAN, PIXEL_STD, dev if d == "card" else "cpu"),
        IDOL_GROUPS, weights, taps=("match", "pos_neg_masks"))
    del card, cpu
    torch.cuda.empty_cache()

    # ---- the entry point: training with a checkpoint, then --resume
    with tempfile.TemporaryDirectory() as tmp:
        register_synthetic(f"{tmp}/data", SWIN_ENTRY_DATASET, YTVIS_2019_CLASSES, num_frames=SWIN_ENTRY_FRAMES)
        argv = ["--config-file", str(Path(__file__).resolve().parent / "configs" / config), "MODEL.WEIGHTS", "",
                "DATASETS.TRAIN", f"('{SWIN_ENTRY_DATASET}',)", "DATASETS.TEST", f"('{SWIN_ENTRY_DATASET}',)",
                "OUTPUT_DIR", f"{tmp}/train", "SOLVER.IMS_PER_BATCH", str(SWIN_TRAIN_CLIPS),
                "SOLVER.CHECKPOINT_PERIOD", "2"]
        resume_or_load, loaded = Checkpointer.resume_or_load, {}

        def checked_resume(self, weights_path, state, resume=True):
            path = self.get_checkpoint_file()
            state, start = resume_or_load(self, weights_path, state, resume)
            if resume:
                saved = torch.load(path, map_location="cpu", weights_only=True)
                loaded.update(path=path, start=start, model=all(torch.equal(v.cpu(), saved["model"][k])
                                                                for k, v in state.model.state_dict().items()),
                              optimizer=same_optimizer_state(state.optimizer.state_dict(), saved["optimizer"]),
                              scheduler=state.scheduler.state_dict() == saved["scheduler"])
            return state, start

        runs = {}
        with patched(Checkpointer, "resume_or_load", checked_resume):
            for run, run_argv, steps in (("train", [*argv, "SOLVER.MAX_ITER", "2"], 2),
                                         ("resume", ["--resume", *argv, "SOLVER.MAX_ITER", "3"], 3)):
                t0 = time.perf_counter()
                trainer = train_net.main(run_argv)
                torch.cuda.synchronize()
                hist = trainer.storage.history("total_loss")
                require(trainer.iter == steps and np.isfinite(hist.values()).all(),
                        f"IDOL-Swin-L train_net {run}: iterations {trainer.start_iter}..{trainer.iter}, "
                        f"total_loss {hist.values()}")
                marker = Path(f"{tmp}/train/last_checkpoint").read_text()
                require(marker == f"model_{steps - 1:07d}.pth", f"IDOL-Swin-L {run}: last_checkpoint names {marker}")
                runs[run] = {"iterations": [trainer.start_iter, trainer.iter], "total_loss": hist.values(),
                             "wall_s": time.perf_counter() - t0}
                print(f"  train_net {run}: iterations {trainer.start_iter}..{trainer.iter - 1}, total_loss "
                      f"{', '.join(f'{v:.3f}' for v in hist.values())}, {runs[run]['wall_s']:.1f} s with the "
                      f"evaluation after training")
                del trainer
                gc.collect()              # the trainer and its hooks refer to each other
                torch.cuda.empty_cache()
        require(loaded.get("start") == 2, f"IDOL-Swin-L --resume started at {loaded.get('start')}")
        require(loaded["model"] and loaded["optimizer"] and loaded["scheduler"],
                f"IDOL-Swin-L --resume: restored state differs from {loaded['path']}")
        print(f"  --resume from {Path(loaded['path']).name}: started at iteration 2; model, optimizer and scheduler "
              f"state equal to the file bit for bit")
        result["entry_point"] = runs
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"  {smi}")
    print(f"[phase 20] IDOL-Swin-L's train step ran {SWIN_TRAIN_STEPS} steps of {SWIN_TRAIN_CLIPS} clips through K4 / "
          f"K5 = 24 / 24 a step at drop-path 0.3; losses finite; trainable reached and landed; card agrees with "
          f"CPU; train_net trained and resumed bit for bit; {result['phase_s']:.1f} s")
    return {"idol_swinl_train": {k: sum(c.get(k, 0) for c in per_step) for k in per_step[0]}}, result


# ---------------------------------------------------------------- phase 22
INSTMOVE_DATASET, INSTMOVE_TRAIN_STEPS, INSTMOVE_TRAIN_BATCH = "ytvis_synthetic_instmove", 20, 16
INSTMOVE_GROUPS = (
    ("mask encoder", ("enc1.", "enc2.", "enc3.", "enc4.")),
    ("ConvLSTM", ("convlstm_",)),
    ("memory", ("memory.",)),
    ("image ResNet-50", ("encoder_img.",)),
    ("gate", ("attn_fc",)),
    ("decoder", ("decoder.",)),
)


def phase_instmove_train(dev, kernels, smi):
    """InstMove training through ``train_instmove.main`` (full width, f32, TF32
    off) on a synthetic YTVIS dataset of 2 videos x 20 frames: 20 steps of 16
    sequences at 192x192, the step time, peak memory and loss curve,
    ``instmove_final``; then the first step's losses and gradients on the card
    against the CPU's on the tool's own first batch."""
    import torch

    from vnext_tpu_torch.data.datasets.synthetic import THING_CLASSES
    from vnext_tpu_torch.models.instmove import build_instmove_model, instmove_loss
    from vnext_tpu_torch.tools import train_instmove as ti

    t_phase = time.perf_counter()
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        register_synthetic(f"{tmp}/data", INSTMOVE_DATASET, THING_CLASSES)
        config = str(Path(__file__).resolve().parent / "configs" / "minvis" / "ovis_r50_motion.yaml")
        argv = ["--config-file", config, "DATASETS.TRAIN", f"('{INSTMOVE_DATASET}',)", "OUTPUT_DIR", f"{tmp}/out",
                "SOLVER.MAX_ITER", str(INSTMOVE_TRAIN_STEPS), "SOLVER.IMS_PER_BATCH", str(INSTMOVE_TRAIN_BATCH),
                "SOLVER.CHECKPOINT_PERIOD", "10"]
        step_ms, make_step = [], ti.make_instmove_step

        def timed_make_step(model, optimizer):
            inner = make_step(model, optimizer)

            def step(*batch):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner(*batch)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                return out

            return step

        zero(kernels)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with patched(ti, "make_instmove_step", timed_make_step):
            model, storage = ti.main(argv)
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        require(counts(kernels) == {}, f"InstMove training launched hand-written kernels {counts(kernels)} (f32: "
                                       "the stem kernel runs in bf16 only)")
        curve = storage.history("total_loss").values()
        require(len(curve) == INSTMOVE_TRAIN_STEPS and np.isfinite(curve).all(), f"InstMove losses {curve}")
        require(next(model.parameters()).is_cuda and model.dtype == torch.float32, "InstMove trained off the card")
        files = sorted(p.name for p in Path(f"{tmp}/out").glob("*.pth"))
        require(files == ["instmove_0000010.pth", "instmove_0000020.pth", "instmove_final.pth"], f"checkpoints {files}")
        cfg = ti.setup(ti.default_argument_parser().parse_args(argv), ti.add_maskformer_config)
        samples = ti.build_mask_sequences(INSTMOVE_DATASET, cfg.MODEL.INSTMOVE.SEQ_LEN,
                                          tuple(cfg.MODEL.INSTMOVE.MASK_SIZE))
        print(f"  train_instmove: {len(samples)} mask sequences of {cfg.MODEL.INSTMOVE.SEQ_LEN} + 1 frames at "
              f"{cfg.MODEL.INSTMOVE.MASK_SIZE[0]}x{cfg.MODEL.INSTMOVE.MASK_SIZE[1]}; {INSTMOVE_TRAIN_STEPS} steps of "
              f"{INSTMOVE_TRAIN_BATCH} in {wall:.1f} s; step ms (synchronized) "
              f"{', '.join(f'{v:.1f}' for v in step_ms)}; peak memory {peak_gb:.2f} GiB; total_loss "
              f"{', '.join(f'{v:.4f}' for v in curve)}; checkpoints {files}")
        result.update(step_ms=step_ms, peak_memory_gb=peak_gb, total_loss=curve, sequences=len(samples), wall_s=wall)
        del model
        torch.cuda.empty_cache()

        # ---- the first step, card vs CPU: the tool's seeded model and its first batch
        rng = np.random.RandomState(max(cfg.SEED, 0))
        rng.randint(0, len(samples), INSTMOVE_TRAIN_BATCH)
        batch = ti.make_batch(samples, rng, INSTMOVE_TRAIN_BATCH, tuple(cfg.MODEL.INSTMOVE.MASK_SIZE),
                              np.asarray(cfg.MODEL.PIXEL_MEAN), np.asarray(cfg.MODEL.PIXEL_STD))
        got = {}
        for where in ("cpu", "card"):
            device = "cpu" if where == "cpu" else dev
            m = build_instmove_model(cfg, device=device, seed=0).train()
            t0 = time.perf_counter()
            past, nxt, imgs = (torch.from_numpy(a).to(device) for a in batch)
            losses = instmove_loss(m(past, imgs, out_len=1), nxt)
            (losses["loss_mask"] + losses["loss_dice"]).backward()
            grads = {g: torch.cat([p.grad.detach().cpu().reshape(-1) for n, p in m.named_parameters()
                                   if n.startswith(prefixes) and p.grad is not None]) for g, prefixes in INSTMOVE_GROUPS}
            got[where] = ({k: float(v.detach()) for k, v in losses.items()}, grads)
            if where == "cpu":
                t_cpu = time.perf_counter() - t0
            del m
        loss_err = {k: abs(got["card"][0][k] - v) / max(abs(v), 1e-6) for k, v in got["cpu"][0].items()}
        grad_err = {g: float((got["card"][1][g] - v).norm() / v.norm().clamp_min(1e-30))
                    for g, v in got["cpu"][1].items()}
        print(f"  first step card vs CPU (both f32, TF32 off; the CPU's forward + backward {t_cpu:.1f} s): losses "
              f"relative error {', '.join(f'{k} {e:.3g}' for k, e in loss_err.items())} tolerance 0.05; gradients "
              f"relative L2 {', '.join(f'{g} {e:.3g}' for g, e in grad_err.items())} tolerance 0.10: f32 sums in "
              "other orders (cuDNN's and the CPU's convolutions)")
        for k, e in loss_err.items():
            require(e <= 0.05, f"InstMove first step: {k} relative error {e}")
        for g, e in grad_err.items():
            require(e <= 0.10, f"InstMove first step: gradient of {g} relative L2 {e}")
        result["card_vs_cpu"] = {"loss_rel_err": loss_err, "grad_rel_l2": grad_err, "cpu_s": t_cpu}
    torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"  {smi}")
    print(f"[phase 22] train_instmove trained {INSTMOVE_TRAIN_STEPS} steps of {INSTMOVE_TRAIN_BATCH} on the card (f32, "
          f"no hand-written kernel), wrote instmove_final; card agrees with CPU; {result['phase_s']:.1f} s")
    return result


# ---------------------------------------------------------------- phase 23
# tracklet slots and detections a frame that no frame of the two videos fills: at random weights the raised
# class bias leaves ~290 of the 300 queries candidates after NMS a frame, and ~500 tracklets live at once
ROOMY = (1024, 300)


def phase_fused_tracker(dev, kernels, smi):
    """IDOL-R50 with ``TPU.FUSED_TRACKER``: the two synthetic videos through the
    fused runner (K1 / K2 / K3 = 12 / 1 / 6 a clip), and its per-frame (query,
    track id) pairs from the serving loop (``_run_clips_fused``) against the
    host tracker's on the same outputs: on every frame at capacities that
    cannot bind, and up to the first frame where the defaults' 32 / 64 bind.
    Also no copy to the host inside a clip (the sync debug mode raising),
    launches per frame, and the time per video beside the host tracker's, at
    the defaults and at the capacities that do not bind (the like-for-like
    one: at the defaults the fused tracker handles a capped subset)."""
    import torch

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vnext_tpu_torch.engine import vis_inference as vi
    from vnext_tpu_torch.models.idol import build_idol_model
    from vnext_tpu_torch.ops import encoder_epilogue, stem_conv
    from vnext_tpu_torch.ops import ms_deform_attn as msda

    t_phase = time.perf_counter()
    cfg = read_config("idol/ytvis19_r50.yaml")
    cfg.TPU.FUSED_TRACKER = True
    model = build_idol_model(cfg, device=dev, seed=0)
    store, records = synthetic_records()
    fused = vi.IDOLVideoInference.from_config(cfg, model, image_loader=store.__getitem__)
    host = vi.IDOLVideoInference.from_config(cfg, model, image_loader=store.__getitem__, fused_tracker=False)
    require(fused.fused_tracker and (fused.fused_capacity, fused.fused_dets) == (32, 64),
            f"the fused runner from the config: {fused.fused_tracker}, {fused.fused_capacity}, {fused.fused_dets}")
    first_clip = {**records[0], "file_names": records[0]["file_names"][:CLIP]}
    raise_class_bias(model, host.infer_clip(*host._prepare_frames(first_clip))["pred_logits"][..., 0])

    track_frames = fused._track_frames

    def no_sync_frames(*args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return track_frames(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    fused._track_frames = no_sync_frames
    roomy = vi.IDOLVideoInference.from_config(cfg, model, image_loader=store.__getitem__, fused_capacity=ROOMY[0],
                                              fused_dets=ROOMY[1])
    for runner in (fused, host, roomy):         # warm-up, not counted
        runner(records[1])
    zero(kernels)
    fused_ms, outs = [], []
    for rec in records:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fused(rec))
        torch.cuda.synchronize()
        fused_ms.append((time.perf_counter() - t0) * 1e3)
    launches = counts(kernels)
    n_clips = sum(-(-r["length"] // CLIP) for r in records)
    want = {msda.KERNEL.name: 12 * n_clips, stem_conv.KERNEL.name: n_clips, encoder_epilogue.KERNEL.name: 6 * n_clips}
    require(launches == want, f"fused serving launches {launches} != {want}")
    check_entries(list(zip(records, outs)), 40)
    video_ms = {"host": [], "roomy": []}
    for rec in records:
        for name, runner in (("host", host), ("roomy", roomy)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner(rec)
            torch.cuda.synchronize()
            video_ms[name].append((time.perf_counter() - t0) * 1e3)

    def associations(per_frame):
        return [sorted((int(q), int(i)) for q, i in frame) for frame in per_frame]

    def host_pairs(outputs):
        """The host association; the tracker's per-frame candidate and
        live-tracklet counts, and its time."""
        tracker, dets, live = host.make_tracker(), [], []
        match = tracker.match

        def counted(*a, **k):
            out = match(*a, **k)
            dets.append(len(a[5]))
            live.append(len(tracker.tracklets))
            return out

        tracker.match = counted
        t0 = time.perf_counter()
        pairs = host.host_track(outputs, tracker)
        return associations(pairs), dets, live, (time.perf_counter() - t0) * 1e3

    def timed_tracking(runner, outputs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.fused_track_video(outputs)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # the pairs of the serving loop, each run against the host tracker on that run's own outputs: at the
    # defaults and at capacities no frame can fill
    equal_frames, bind_at, tracking_ms = 0, [], {"fused": [], "roomy": [], "host": []}
    for rec in records:
        frames, size = fused._prepare_frames(rec)
        outputs, pairs = fused._run_clips_fused(frames, size)
        want_pairs, dets, live, host_ms_video = host_pairs(outputs)
        tracking_ms["host"].append(host_ms_video)
        tracking_ms["fused"].append(timed_tracking(fused, outputs))
        tracking_ms["roomy"].append(timed_tracking(roomy, outputs))
        roomy_outputs, roomy_pairs = roomy._run_clips_fused(frames, size)
        roomy_want, roomy_dets, roomy_live, _ = host_pairs(roomy_outputs)
        roomy_pairs, pairs = associations(roomy_pairs), associations(pairs)
        require(len(pairs) == len(roomy_pairs) == rec["length"],
                f"video {rec['video_id']}: {len(pairs)} / {len(roomy_pairs)} frames tracked of {rec['length']}")
        for t, (a, b) in enumerate(zip(roomy_pairs, roomy_want)):
            if a != b:
                print(f"  video {rec['video_id']} frame {t}: fused {a}, host {b}; the frame's top scores "
                      f"{np.sort(1 / (1 + np.exp(-roomy_outputs['pred_logits'][t].max(-1))))[::-1][:6]}")
                break
        require(max(roomy_live) <= ROOMY[0] and max(roomy_dets) <= ROOMY[1],
                f"video {rec['video_id']}: {max(roomy_live)} live tracklets, {max(roomy_dets)} candidates: capacities "
                f"{ROOMY} bind")
        require(roomy_pairs == roomy_want, f"video {rec['video_id']}: the served fused tracker at capacities {ROOMY} "
                                           "differs from the host tracker")
        binds = [t for t in range(len(dets)) if dets[t] > fused.fused_dets or live[t] > fused.fused_capacity]
        upto = binds[0] if binds else len(dets)
        bind_at.append(binds[0] if binds else None)
        require(pairs[:upto] == want_pairs[:upto], f"video {rec['video_id']}: the fused tracker differs from the host "
                                                   f"tracker before capacity binds (frame {upto})")
        equal_frames += upto
        print(f"  video {rec['video_id']}: {len(dets)} frames in {-(-len(dets) // CLIP)} clips (the last padded), "
              f"candidates after NMS a frame {min(dets)}..{max(dets)} (cap {fused.fused_dets}), live tracklets "
              f"{min(live)}..{max(live)} (cap {fused.fused_capacity}); "
              + (f"capacity binds from frame {binds[0]}, " if binds else "capacity never binds, ")
              + f"served pairs equal to the host tracker's on {upto} frames at the defaults and on all "
                f"{len(roomy_pairs)} at {ROOMY[0]} / {ROOMY[1]}")
    # launches per frame: the fused tracker's device kernels over one clip
    frames, size = fused._prepare_frames(first_clip)
    out = fused.forward_clip(frames, size)
    state = fused.init_fused_state(out["pred_logits"].shape[1], out["pred_inst_embed"].shape[-1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        track_frames(state, out, CLIP, 0)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    per_frame = sum(e.count for e in events) / CLIP
    busy = sum(e.self_device_time_total for e in events) / 1e3 / CLIP
    def ms(values):
        return ", ".join(f"{v:.1f}" for v in values)

    print(f"  serving per video: fused at the defaults {ms(fused_ms)} ms (a capped subset), fused at {ROOMY[0]} / "
          f"{ROOMY[1]} {ms(video_ms['roomy'])} ms (the same work as the host), host tracker {ms(video_ms['host'])} ms; "
          f"the tracking alone per video (host outputs in): fused at the defaults {ms(tracking_ms['fused'])} ms, at "
          f"{ROOMY[0]} / {ROOMY[1]} {ms(tracking_ms['roomy'])} ms, host {ms(tracking_ms['host'])} ms; the fused "
          f"tracker launches {per_frame:.0f} device kernels a frame at the defaults (busy {busy:.3f} ms a frame); no "
          "copy to the host inside a clip (the sync debug mode raising)")
    result = {"fused_video_ms": fused_ms, "roomy_video_ms": video_ms["roomy"], "host_video_ms": video_ms["host"],
              "tracking_ms": tracking_ms, "launches_per_frame": per_frame, "device_busy_ms_per_frame": busy,
              "capacity_binds_at": bind_at, "frames_equal_at_defaults": equal_frames}
    del model, fused, host, roomy, prof
    torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"  {smi}")
    print(f"[phase 23] IDOL-R50 with TPU.FUSED_TRACKER: K1 / K2 / K3 = 12 / 1 / 6 a clip, served tracks equal to the "
          f"host tracker's where capacity does not bind, no host copy inside a clip; {result['phase_s']:.1f} s")
    return {"idol_fused_serving": launches}, result


# ---------------------------------------------------------------- phase 24
COCO_DATASET, COCO_EVAL_DATASET = "coco_synthetic_pretrain", "ytvis_synthetic_pretrain_eval"
COCO_IMAGES, COCO_HW = 32, (480, 640)          # COCO-like 4:3 stills: resize, crop and flip all do work
COCO_CLIPS, COCO_STEPS, COCO_SPLIT, COCO_SWIN_STEPS = 4, 4, 2, 2
COCO_EVAL_FRAMES = 3
# the yaml's 80 classes as the evaluation json's categories: every label the model predicts has one
COCO_CLASSES = tuple(f"coco_class_{i}" for i in range(80))
D2_PREFIX = "detr.detr.backbone.0.backbone."


def write_r50_pkl(path, seed):
    """A torchvision-form detectron2 ImageNet init (``R-50.pkl``'s layout: a plain
    pickle of ``{"model": {d2 name: array}, "__author__": "torchvision"}``) of a
    ResNet-50 seeded with ``seed``; returns its {d2 name: tensor}."""
    import pickle

    import torch

    from vnext_tpu_torch.checkpoint.torch_import import to_reference_names
    from vnext_tpu_torch.models.backbones.resnet import ResNet
    from vnext_tpu_torch.models.layers import init_weights

    wrapper = torch.nn.Module()
    wrapper.backbone = ResNet(depth=50)
    init_weights(wrapper, seed)
    d2 = {k[len(D2_PREFIX):]: v for k, v in to_reference_names(wrapper.state_dict(), "idol").items()}
    with open(path, "wb") as f:
        pickle.dump({"model": {k: v.numpy() for k, v in d2.items()}, "__author__": "torchvision",
                     "matching_heuristics": True}, f)
    return d2


def backbone_differs_from(model, d2):
    """The d2 names of ``model``'s backbone tensors that differ from ``d2``'s (the .pkl's)."""
    from vnext_tpu_torch.checkpoint.torch_import import to_reference_names

    import torch

    own = to_reference_names({k: v for k, v in model.state_dict().items() if k.startswith("backbone.")}, "idol")
    return [k for k, v in own.items() if not torch.equal(v.cpu(), d2[k[len(D2_PREFIX):]].to(v.dtype))]


def batch_digest(batch):
    """One sha1 over a collated batch's arrays (names sorted)."""
    import hashlib

    h = hashlib.sha1()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


def coco_pretrain_run(label, argv, kernels, pkl=None, stem=True, n_loss_keys=32):
    """``train_net.main(argv)`` on the COCO-pretrain stage, instrumented: each
    step's start, the host time ``next(loader)`` blocked, each batch's digest,
    the launches in the train steps and in the evaluation after training, the
    checkpoint saves, what the load or resume restored, and peak memory.
    Requires K4 / K5 (/ K2 with ``stem``) = 24 / 24 (/ 2) a step, the step's
    ``n_loss_keys`` loss keys finite at every step, and, with ``pkl``, the
    backbone equal to the file's tensors right after the load. Returns the
    trainer and the record."""
    import torch

    from vnext_tpu_torch.checkpoint.checkpointer import Checkpointer
    from vnext_tpu_torch.tools import train_net

    step_starts, waits, digests, eval_deltas, saves, loaded = [], [], [], [], [], {}
    build_loader, do_eval = train_net.build_vis_train_loader, train_net.do_eval
    save, resume_or_load = Checkpointer.save, Checkpointer.resume_or_load

    class TimedTrainer(train_net.VISTrainer):
        def run_step(self):
            step_starts.append(time.perf_counter())
            super().run_step()

    def timed_loader(*args, **kwargs):
        loader = build_loader(*args, **kwargs)

        def batches():
            while True:
                t1 = time.perf_counter()
                batch = next(loader)
                waits.append((time.perf_counter() - t1) * 1e3)
                digests.append(batch_digest(batch))
                yield batch

        return batches()

    def counted_eval(cfg, model=None):
        before = counts(kernels)
        out = do_eval(cfg, model)
        torch.cuda.synchronize()
        eval_deltas.append(minus(counts(kernels), before))
        return out

    def timed_save(self, name, state):
        t1 = time.perf_counter()
        path = save(self, name, state)
        saves.append((t1, time.perf_counter()))
        return path

    def checked_load(self, weights_path, state, resume=True):
        path = self.get_checkpoint_file() if resume and self.has_checkpoint() else None
        state, start = resume_or_load(self, weights_path, state, resume)
        torch.cuda.synchronize()
        loaded["start"] = start
        if path is not None:
            saved = torch.load(path, map_location="cpu", weights_only=True)
            loaded.update(path=path, model=all(torch.equal(v.cpu(), saved["model"][k])
                                               for k, v in state.model.state_dict().items()),
                          optimizer=same_optimizer_state(state.optimizer.state_dict(), saved["optimizer"]),
                          scheduler=state.scheduler.state_dict() == saved["scheduler"])
        elif pkl is not None:
            loaded["backbone_differs"] = backbone_differs_from(state.model, pkl)
        return state, start

    zero(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patched(train_net, "VISTrainer", TimedTrainer), patched(train_net, "build_vis_train_loader", timed_loader), \
            patched(train_net, "do_eval", counted_eval), patched(Checkpointer, "save", timed_save), \
            patched(Checkpointer, "resume_or_load", checked_load):
        trainer = train_net.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    total = counts(kernels)
    require(len(eval_deltas) == 1, f"{label}: {len(eval_deltas)} evaluations, expected the one after training")
    in_train = minus(total, eval_deltas[0])
    n = trainer.iter - trainer.start_iter
    want = {"ms_deform_attn_v9_fwd": 24 * n, "ms_deform_attn_v9_bwd": 24 * n, **({"stem_conv": 2 * n} if stem else {})}
    require(in_train == want, f"{label}: train launch counts {in_train} != {want}")
    hist = trainer.storage.histories()
    losses = sorted(k for k in hist if k.startswith("loss_"))
    require(len(losses) == n_loss_keys, f"{label}: {len(losses)} loss keys, expected {n_loss_keys}: {losses}")
    for k in losses + ["total_loss"]:
        require(hist[k].count() == n and np.isfinite(hist[k].values()).all(), f"{label} {k}: {hist[k].values()}")
    if pkl is not None and "backbone_differs" in loaded:
        require(not loaded["backbone_differs"], f"{label}: backbone tensors differ from the .pkl after the load: "
                                                f"{loaded['backbone_differs'][:5]}")
    periods = [(b - a - sum(e - s for s, e in saves if a <= s < b)) * 1e3 for a, b in zip(step_starts, step_starts[1:])]
    record = {"iterations": [trainer.start_iter, trainer.iter], "launches": in_train, "eval_launches": eval_deltas[0],
              "step_period_ms": periods, "loader_wait_ms": list(waits), "peak_gib": peak_gib,
              "total_loss": hist["total_loss"].values(), "wall_s": wall, "batch_digests": digests[:n],
              "loaded": {k: v for k, v in loaded.items() if k != "backbone_differs"}}
    print(f"  {label}: iterations {trainer.start_iter}..{trainer.iter - 1}; launches in the train steps {in_train} "
          f"(expected {want}), in the evaluation after training {eval_deltas[0]}; {len(losses)} loss keys finite; "
          f"total_loss {', '.join(f'{v:.3f}' for v in hist['total_loss'].values())}")
    print(f"  {label}: step period (host clock between step starts, less a checkpoint save between them) "
          f"{', '.join(f'{v:.1f}' for v in periods)} ms; next(loader) blocked "
          f"{', '.join(f'{v:.1f}' for v in waits[:n])} ms; peak memory {peak_gib:.2f} GiB (the evaluation "
          f"after training included); {wall:.1f} s with the model's build, the load and the evaluation")
    return trainer, record


def phase_coco_pretrain(dev, kernels, smi):
    """IDOL's COCO-pretrain stage through ``train_net.main`` (``INPUT.COCO_PRETRAIN
    True``) at ``configs/idol/coco_pretrain/r50_coco_sequence.yaml``'s width on a
    synthetic COCO set at 480x640, from a torchvision-form ``R-50.pkl`` written
    from a seeded ResNet-50: the backbone on the card equals the file's after the
    load, K4 / K5 / K2 = 24 / 24 / 2 a step, 32 finite loss keys a step; a
    2-step run resumed to 4 against the straight 4-step run; then
    ``swin_coco_sequence.yaml`` for 2 steps with no weights."""
    import torch

    from vnext_tpu_torch.data import DatasetCatalog
    from vnext_tpu_torch.data.datasets.synthetic import register_synthetic_coco

    t_phase = time.perf_counter()
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        register_synthetic_coco(COCO_DATASET, root=f"{tmp}/coco", num_images=COCO_IMAGES, h=COCO_HW[0], w=COCO_HW[1])
        register_synthetic(f"{tmp}/eval", COCO_EVAL_DATASET, COCO_CLASSES, num_frames=COCO_EVAL_FRAMES)
        pkl = write_r50_pkl(f"{tmp}/R-50.pkl", seed=5)
        records = DatasetCatalog.get(COCO_DATASET)
        print(f"  synthetic COCO set: {len(records)} images at {COCO_HW[0]}x{COCO_HW[1]} (PNG), "
              f"{sum(len(r['annotations']) for r in records)} objects; R-50.pkl ({len(pkl)} tensors, torchvision "
              f"form) and the evaluation set written in {time.perf_counter() - t0:.1f} s")
        configs = Path(__file__).resolve().parent / "configs" / "idol" / "coco_pretrain"
        common = ["INPUT.COCO_PRETRAIN", "True", "DATASETS.TRAIN", f"('{COCO_DATASET}',)",
                  "DATASETS.TEST", f"('{COCO_EVAL_DATASET}',)", "SOLVER.IMS_PER_BATCH", str(COCO_CLIPS),
                  "SOLVER.CHECKPOINT_PERIOD", str(COCO_SPLIT)]
        r50 = ["--config-file", str(configs / "r50_coco_sequence.yaml"), "MODEL.WEIGHTS", f"{tmp}/R-50.pkl", *common]
        runs, finals = {}, {}
        for name, argv in (("straight", [*r50, "OUTPUT_DIR", f"{tmp}/a", "SOLVER.MAX_ITER", str(COCO_STEPS)]),
                           ("split", [*r50, "OUTPUT_DIR", f"{tmp}/b", "SOLVER.MAX_ITER", str(COCO_SPLIT)]),
                           ("resume", ["--resume", *r50, "OUTPUT_DIR", f"{tmp}/b", "SOLVER.MAX_ITER", str(COCO_STEPS)])):
            trainer, runs[name] = coco_pretrain_run(f"IDOL-R50 {name}", argv, kernels, pkl=pkl)
            finals[name] = {k: v.detach().cpu().clone() for k, v in trainer.state.model.state_dict().items()}
            del trainer
            gc.collect()              # the trainer and its hooks refer to each other
            torch.cuda.empty_cache()
        straight, resumed = runs["straight"], runs["resume"]
        require(runs["straight"]["loaded"] == {"start": 0} and runs["split"]["loaded"] == {"start": 0},
                f"the straight and the 2-step runs loaded {runs['straight']['loaded']}, {runs['split']['loaded']}")
        got = resumed["loaded"]
        require(got.get("start") == COCO_SPLIT and got["model"] and got["optimizer"] and got["scheduler"],
                f"--resume: started at {got.get('start')}, restored state equal to {got.get('path')}: {got}")
        # both packages start the loader again from its seed on --resume: the resumed steps take the straight
        # run's first batches, so the two runs' last steps train on other batches
        require(resumed["batch_digests"] == straight["batch_digests"][:COCO_STEPS - COCO_SPLIT],
                "--resume: the resumed steps' batches are not the loader's first ones")
        require(runs["split"]["batch_digests"] == straight["batch_digests"][:COCO_SPLIT],
                "the 2-step run's batches differ from the straight run's first two")
        ckpt = {r: torch.load(f"{tmp}/{d}/model_{COCO_SPLIT - 1:07d}.pth", map_location="cpu", weights_only=True)["model"]
                for r, d in (("straight", "a"), ("split", "b"))}

        def max_rel(a, b):
            return max(float((a[k].float() - b[k].float()).abs().max() / b[k].float().abs().max().clamp_min(1e-30))
                       for k in b if b[k].is_floating_point())

        same_at_split = all(torch.equal(ckpt["straight"][k], ckpt["split"][k]) for k in ckpt["split"])
        result["resume"] = {
            "restored_bit_for_bit": True, "start": got["start"],
            "state_at_step_2_equal": same_at_split,
            "state_at_step_2_max_rel_diff": max_rel(ckpt["straight"], ckpt["split"]),
            "final_equal": all(torch.equal(finals["straight"][k], finals["resume"][k]) for k in finals["resume"]),
            "final_max_rel_diff": max_rel(finals["resume"], finals["straight"])}
        print(f"  --resume from model_{COCO_SPLIT - 1:07d}.pth: started at iteration {got['start']}, model, "
              f"optimizer and scheduler equal to the file bit for bit; its steps took the loader's first "
              f"{COCO_STEPS - COCO_SPLIT} batches again (as JAX's loader does). The straight run's step-{COCO_SPLIT} "
              f"checkpoint against the 2-step run's: equal bit for bit {same_at_split}, largest relative "
              f"difference {result['resume']['state_at_step_2_max_rel_diff']:.3e} (the same batches and draws: the "
              f"backward's f32 atomic sums, K5's value gradient among them, differ in their last bits from run to "
              f"run, and AdamW's first steps move an element by about the learning rate whatever its gradient's "
              f"size); the final states: equal {result['resume']['final_equal']}, "
              f"largest relative difference {result['resume']['final_max_rel_diff']:.3e} (other batches after "
              f"the resume)")
        del finals, ckpt
        result.update(straight=straight, split=runs["split"], resumed=resumed)

        # ---- IDOL-Swin-L's pretrain steps (no cocopretrain_SwinL.pth in the repository: seeded weights)
        swin = ["--config-file", str(configs / "swin_coco_sequence.yaml"), "MODEL.WEIGHTS", "", *common,
                "OUTPUT_DIR", f"{tmp}/swin", "SOLVER.MAX_ITER", str(COCO_SWIN_STEPS)]
        trainer, result["swin"] = coco_pretrain_run("IDOL-Swin-L", swin, kernels, stem=False)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    result["phase_s"] = time.perf_counter() - t_phase
    per_step = {k: straight["launches"].get(k, 0) // COCO_STEPS
                for k in ("ms_deform_attn_v9_fwd", "ms_deform_attn_v9_bwd", "stem_conv")}
    print(f"  {smi}")
    print(f"[phase 24] IDOL's COCO-pretrain stage through train_net: the .pkl backbone landed, K4 / K5 / K2 = "
          f"{per_step['ms_deform_attn_v9_fwd']} / {per_step['ms_deform_attn_v9_bwd']} / {per_step['stem_conv']} a "
          f"step, 32 loss keys finite, --resume restored bit for bit; IDOL-Swin-L {COCO_SWIN_STEPS} steps at peak "
          f"{result['swin']['peak_gib']:.2f} GiB; {result['phase_s']:.1f} s")
    return {"coco_pretrain_train": straight["launches"], "coco_pretrain_swinl_train": result["swin"]["launches"]}, result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke test of the port on one NVIDIA GPU; "
                                                 "with no argument, every phase.")
    parser.add_argument("--only", choices=("train_numerics", "entry_point", "minvis_entry", "seqformer_train",
                                           "swin_train", "instmove_train", "fused_tracker", "coco_pretrain"),
                        help="phase 1 and this phase alone (train_numerics: phase 6; entry_point: phase 17; "
                             "minvis_entry: phase 2b's MinVIS and SeqFormer shapes and phase 18; seqformer_train: "
                             "phase 19; swin_train: phases 20 and 21; instmove_train: K2 at InstMove's shape and "
                             "phase 22; fused_tracker: phase 23; coco_pretrain: phase 24)")
    parser.add_argument("--tree", help="with --only: import vnext_tpu_torch from this checkout (an "
                                       "earlier commit's `git archive`) in place of the one beside this script")
    parser.add_argument("--swap-plain", action="append", default=[], choices=("K2", "K4"),
                        help="with --only train_numerics: also run the card's forward with this "
                             "kernel's plain version on the card (repeatable)")
    args = parser.parse_args(argv)
    if (args.tree or args.swap_plain) and args.only != "train_numerics":
        parser.error("--tree and --swap-plain go with --only train_numerics")
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
        from vnext_tpu_torch.ops import encoder_epilogue, stem_conv
        from vnext_tpu_torch.ops import ms_deform_attn as msda

        kernels = {k.name: k for k in (msda.KERNEL, stem_conv.KERNEL, encoder_epilogue.KERNEL, msda.KERNEL_V9_FWD,
                                       msda.KERNEL_V9_BWD)}
        if args.only == "train_numerics":
            phase_train_numerics(dev, args.swap_plain)
        elif args.only == "entry_point":
            _, entry = phase_entry_point(dev, kernels, smi, measure=True)
            print(json.dumps({"entry_point": entry}))
        elif args.only == "minvis_entry":
            shapes = phase_new_train_kernels(dev)
            launches, entry = phase_minvis_entry(dev, kernels, smi)
            print(json.dumps({"kernels_at_new_shapes": shapes, "minvis_entry": entry, "launches": launches}))
        elif args.only == "seqformer_train":
            launches, train = phase_seqformer_train(dev, kernels, smi)
            print(json.dumps({"seqformer_train": train, "launches": launches}))
        elif args.only == "swin_train":
            idol_launches, idol_train = phase_idol_swin_train(dev, kernels, smi)
            seq_launches, seq_train = phase_seqformer_swin_train(dev, kernels, smi)
            print(json.dumps({"idol_swinl_train": idol_train, "seqformer_swinl_train": seq_train,
                              "launches": {**idol_launches, **seq_launches}}))
        elif args.only == "instmove_train":
            k2 = stem_serving_case(dev, np.random.RandomState(13), (INSTMOVE_BATCH, *INSTMOVE_HW, 3))
            print(json.dumps({"k2_instmove": k2, "instmove_train": phase_instmove_train(dev, kernels, smi)}))
        elif args.only == "fused_tracker":
            launches, fused = phase_fused_tracker(dev, kernels, smi)
            print(json.dumps({"fused_tracker": fused, "launches": launches}))
        else:
            launches, coco = phase_coco_pretrain(dev, kernels, smi)
            print(json.dumps({"coco_pretrain": coco, "launches": launches}))
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
    measured.update(phase_new_train_kernels(dev))
    more, cm_inputs = phase_more_kernels(dev)
    measured.update(more)
    entry_launches = phase_entry_points(kernels, cm_inputs)
    del cm_inputs
    model, runner, record, cfg, serve_launches, timing = phase_main_path(dev, kernels)
    phase_numerics(model, runner, record, cfg)
    route_launches, route_forward_ms = phase_selector_serve(dev, kernels, model, runner, record)
    del model, runner
    torch.cuda.empty_cache()
    seq_model, seq_runner, seq_record, seq_cfg, seq_launches, seq_timing = phase_seqformer(dev, kernels)
    phase_seqformer_numerics(seq_model, seq_runner, seq_record, seq_cfg)
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
    del mv_model, mv_runner
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    swin_model, swin_runner, swin_record, swin_cfg, swin_launches, swin_timing = phase_main_path(
        dev, kernels, "idol/ytvis19_swinL.yaml", "IDOL-Swin-L", tag="14")
    phase_numerics(swin_model, swin_runner, swin_record, swin_cfg, tag="14")
    del swin_runner
    phase_seconds["14"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sq_model, sq_runner, sq_record, sq_cfg, seq_swin_launches, seq_swin_timing = phase_seqformer(
        dev, kernels, "seqformer/swin_ytvis.yaml", "SeqFormer-Swin-L", tag="15")
    phase_seqformer_numerics(sq_model, sq_runner, sq_record, sq_cfg, tag="15")
    del sq_model, sq_runner
    torch.cuda.empty_cache()
    phase_seconds["15"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    r101_launches, r101_timing, import_result = phase_r101_and_import(dev, kernels, swin_model, swin_cfg)
    del swin_model
    phase_seconds["16"] = time.perf_counter() - t0
    entry_point_launches, entry_result = phase_entry_point(dev, kernels, smi)
    phase_seconds["17"] = entry_result["phase_s"]
    torch.cuda.empty_cache()
    minvis_entry_launches, minvis_entry_result = phase_minvis_entry(dev, kernels, smi)
    phase_seconds["18"] = minvis_entry_result["phase_s"]
    seq_train_launches, seq_train_result = phase_seqformer_train(dev, kernels, smi)
    phase_seconds["19"] = seq_train_result["phase_s"]
    swin_train_launches, swin_train_result = phase_idol_swin_train(dev, kernels, smi)
    phase_seconds["20"] = swin_train_result["phase_s"]
    seq_swin_train_launches, seq_swin_train_result = phase_seqformer_swin_train(dev, kernels, smi)
    phase_seconds["21"] = seq_swin_train_result["phase_s"]
    instmove_train_result = phase_instmove_train(dev, kernels, smi)
    phase_seconds["22"] = instmove_train_result["phase_s"]
    fused_launches, fused_result = phase_fused_tracker(dev, kernels, smi)
    phase_seconds["23"] = fused_result["phase_s"]
    coco_launches, coco_result = phase_coco_pretrain(dev, kernels, smi)
    phase_seconds["24"] = coco_result["phase_s"]
    print("  seconds by phase: " + ", ".join(f"{k}: {v:.1f}" for k, v in phase_seconds.items()))

    print(json.dumps({
        "slice": timing, "seqformer": seq_timing, "train": train_timing, "minvis": minvis_timing,
        "instmove": instmove_timing, "idol_swinL": swin_timing, "seqformer_swinL": seq_swin_timing,
        "idol_r101": r101_timing, "reference_import": import_result, "entry_point": entry_result,
        "minvis_entry": minvis_entry_result, "seqformer_train": seq_train_result,
        "idol_swinl_train": swin_train_result, "seqformer_swinl_train": seq_swin_train_result,
        "instmove_train": instmove_train_result, "fused_tracker": fused_result, "coco_pretrain": coco_result,
        "phase_seconds": phase_seconds,
        "idol_forward_ms_by_impl": {"auto": timing["forward_ms"], **route_forward_ms},
        "msda_decoder_form": measured["dec"], "k4_decoder_form": measured["fwd_decoder"],
        "k5_decoder_form": measured["bwd_decoder"], "k6_backward_decoder_form": measured["bwd6_decoder"],
        "k2_serving": measured["stem"], "k4_serving": {f: measured[f"route_auto_{f}"] for f in ("enc", "dec")},
        "routes_serving": {impl: {f: measured[f"route_{impl}_{f}"] for f in ("enc", "dec")} for impl in ROUTES},
    }))
    paths = {"serve": serve_launches, "seqformer": seq_launches,
             **{f"serve_{impl}": route_launches[impl] for impl in ROUTES},
             "train": train_launches, "train_pallas": route_train_launches, "entry_points": entry_launches,
             "minvis": minvis_launches, "instmove": instmove_launches, "idol_swinL": swin_launches,
             "seqformer_swinL": seq_swin_launches, "idol_r101": r101_launches, **entry_point_launches,
             **minvis_entry_launches, **seq_train_launches, **swin_train_launches, **seq_swin_train_launches,
             **fused_launches, **coco_launches}
    for path, names in (("minvis_entry_eval", (msda.KERNEL, stem_conv.KERNEL, encoder_epilogue.KERNEL)),
                        ("minvis_entry_train", (msda.KERNEL_V9_FWD, msda.KERNEL_V9_BWD, stem_conv.KERNEL)),
                        ("seqformer_train", (msda.KERNEL_V9_FWD, msda.KERNEL_V9_BWD, stem_conv.KERNEL)),
                        ("idol_swinl_train", (msda.KERNEL_V9_FWD, msda.KERNEL_V9_BWD)),
                        ("seqformer_swinl_train", (msda.KERNEL_V9_FWD, msda.KERNEL_V9_BWD)),
                        ("idol_fused_serving", (msda.KERNEL, stem_conv.KERNEL, encoder_epilogue.KERNEL)),
                        ("coco_pretrain_train", (msda.KERNEL_V9_FWD, msda.KERNEL_V9_BWD, stem_conv.KERNEL)),
                        ("coco_pretrain_swinl_train", (msda.KERNEL_V9_FWD, msda.KERNEL_V9_BWD))):
        for kern in names:
            require(paths[path].get(kern.name, 0) > 0, f"{kern.name}: no launch on the {path} path")
    # K4, K5 and K2 at the new train steps' shapes, beside their rows' train-step shape
    at_shapes = {kern.name: {"minvis_train_encoder": measured[f"{d}_minvis_train"],
                             "seqformer_train_encoder": measured[f"{d}_seqformer_enc"],
                             "seqformer_train_decoder": measured[f"{d}_seqformer_dec"]}
                 for kern, d in ((msda.KERNEL_V9_FWD, "fwd"), (msda.KERNEL_V9_BWD, "bwd"))}
    at_shapes[stem_conv.KERNEL.name] = {"minvis_train": measured["stem_minvis_train"],
                                        "seqformer_train": measured["stem_seqformer_train"],
                                        "instmove_serving": measured["stem_instmove"]}
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
         **measured[key], **({"at_shapes": at_shapes[kern.name]} if kern.name in at_shapes else {})}
        for kern, path, key in rows
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
