"""Time K1 (the fused MSDA forward, both forms), K2 (the stem, serving and
train shapes), K3 (the encoder epilogue), K4 (the MSDA standard-entry forward,
both train forms and the serving encoder), K4b (the channel-major entry), K5
(the MSDA backward, both forms) and K9 (the dynamic-offset accumulate probe)
of two checkouts of the port in one process tree, in turns.

    python -m vnext_tpu_torch.tools.kernel_ab --parent build/parent

runs the timing once per tree in the order parent, change, change, parent, each
in its own process that imports ``vnext_tpu_torch`` from that tree (the
parent's kernels build into the parent's own ``build/``), and prints one JSON
line per run and a summary with each kernel's median per tree and the ratio
change / parent. The inputs are ``chip_smoke.py``'s, made from fixed seeds in
every run: phase 2a's at IDOL-R50's serving shapes (B = 10, 480x864: K1's
encoder point form at Q = S = 8617 and decoder box form at Q = 300, K3 at
[10, 8617, 256] with F = 1024), phase 2b's at the train shapes (the stem at
[4, 512, 640, 3]; K4 and K5 at B = 4, 512x640, Q = S = 6800 and Q = 300) and
phase 2c's at the serving encoder (K4 through ``impl="pallas_v9"``, K4b
through ``ms_deform_attn_cm`` with its value transpose, at B = 10, Q = S =
8617), and K9 at the probe's shape. Times are
CUDA events on one card, the median over ``--reps`` samples after warm-up:
``ms`` times one call per event pair, as ``chip_smoke.py`` does, so it includes
the wrapper's host work when the card waits for it; ``stream_ms`` times 20
calls between two events, per call, so the host runs ahead wherever the kernel
takes longer than the wrapper. K9's wrapper takes longer than its kernel, so
for it ``device_ms`` also gives the kernel's own time per call by
``torch.profiler`` (20 calls).

    python -m vnext_tpu_torch.tools.kernel_ab --parent build/parent --atomics-off

also times K5 of each tree with its value-gradient reductions removed (a copy
of the package under ``build/ab_atomics_off/`` whose backward source has every
line that calls ``atomicAdd`` deleted), in the same turns: what is left is the
gather, the sums and the stores, so the difference is the reductions' share.

    python -m vnext_tpu_torch.tools.kernel_ab --root build/parent --one

times one tree and prints its JSON line (what each turn above runs).

    python -m vnext_tpu_torch.tools.kernel_ab --sass

prints, from this tree's library as compiled (``cuobjdump -sass``; another
tree's with ``--root``): K1's (``msda_fwd_kernel``), K4's and K4b's
(``msda_fwd_loc*``) 128-bit global loads, how many of them each stretch
between two f32 FMAs issues, and their instruction count; K3's (``encoder_epilogue_kernel``) HGMMA
instructions by shape; K5's (``msda_bwd_kernel``) reduction and atomic
instructions by their full opcode, which carries the width.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

LEVELS = ((60, 108), (30, 54), (15, 27), (8, 14))
B, M, D, L, P = 10, 8, 32, 4, 4
STEM_SHAPES = {"serving": (10, 480, 864, 3), "train": (4, 512, 640, 3)}
TRAIN_B, TRAIN_LEVELS = 4, ((64, 80), (32, 40), (16, 20), (8, 10))
C, F = 256, 1024
HERE = Path(__file__).resolve().parents[2]
STRIPPED = HERE / "build" / "ab_atomics_off"


def _time_ms(fn, reps, calls=1):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _inputs(dev):
    """The K1 and K2 inputs of chip_smoke.py phase 2a (and K2's of phase 2b)."""
    import torch

    rng = np.random.RandomState(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)

    s = sum(h * w for h, w in LEVELS)
    value = rng.randn(B, s, M, D)
    start = 0
    for h, w in LEVELS:
        value[:, start + np.arange(h) * w + (w - 1)] = 0.0
        start += h * w
    value = t(value, torch.bfloat16)
    ref_pts = []
    for h, w in LEVELS:
        yy, xx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        ref_pts.append(np.stack([xx.ravel(), yy.ravel()], -1))
    ref_enc = np.broadcast_to(np.concatenate(ref_pts)[None, :, None, :], (B, s, L, 2))
    off = rng.randn(B, s, M, L, P, 2) * 3.0
    off[..., 0, :] = np.round(off[..., 0, :])
    far = rng.rand(B, s, M, L, P) < 0.02
    off[far] = rng.choice([-300.0, 300.0], size=(far.sum(), 2))
    enc = (value, LEVELS, t(off, torch.bfloat16), t(ref_enc),
           t(rng.randn(B, s, M, L * P) * 2.0, torch.bfloat16))
    q = 300
    boxes = np.concatenate([rng.rand(B, q, 1, 2), rng.rand(B, q, 1, 2) * 0.45 + 0.05], -1)
    dec = (value, LEVELS, t(rng.randn(B, q, M, L, P, 2) * 3.0, torch.bfloat16),
           t(np.broadcast_to(boxes, (B, q, L, 4))), t(rng.randn(B, q, M, L * P) * 2.0, torch.bfloat16))
    k = t(rng.randn(7, 7, 3, 64) * 0.1)
    scale, bias = t(rng.rand(64) + 0.5), t(rng.randn(64) * 0.1)
    stems = {name: (t(rng.randn(*shape)), k, scale, bias) for name, shape in STEM_SHAPES.items()}
    epilogue = (t(rng.randn(B, s, C) * 0.5, torch.bfloat16), t(rng.randn(B, s, C), torch.bfloat16),
                t(rng.rand(C) + 0.5), t(rng.randn(C) * 0.1), t(rng.randn(F, C) * 0.06), t(rng.randn(F) * 0.1),
                t(rng.randn(C, F) * 0.03), t(rng.randn(C) * 0.1), t(rng.rand(C) + 0.5), t(rng.randn(C) * 0.1))
    return enc, dec, stems, epilogue, _backward_inputs(dev)


def _backward_inputs(dev):
    """K5's inputs as phase 2b makes them: padded value rows zero, a quarter of
    the samples on pixel centres, 2% far outside, softmaxed weights."""
    import torch

    rng = np.random.RandomState(1)
    b, s = TRAIN_B, sum(h * w for h, w in TRAIN_LEVELS)
    wh = np.asarray([[w, h] for h, w in TRAIN_LEVELS], np.float64)
    value = rng.randn(b, s, M, D)
    start = 0
    for h, w in TRAIN_LEVELS:
        grid = np.arange(h * w).reshape(h, w)
        value[:, start + np.concatenate([grid[:, -2:].ravel(), grid[-1]])] = 0.0
        start += h * w
    value = torch.from_numpy(value.astype(np.float32)).to(dev, torch.bfloat16)
    forms = {}
    for form, q in (("encoder", s), ("decoder", 300)):
        loc = rng.rand(b, q, M, L, P, 2) * 1.2 - 0.1
        k = rng.randint(0, 10 ** 6, size=loc.shape) % wh[None, None, None, :, None, :].astype(int)
        centre = rng.rand(b, q, M, L, P) < 0.25
        loc[centre] = ((k + 0.5) / wh[None, None, None, :, None, :])[centre]
        far = rng.rand(b, q, M, L, P) < 0.02
        loc[far] = rng.choice([-4.0, 5.0], size=(int(far.sum()), 2))
        logits = torch.from_numpy(rng.randn(b, q, M, L * P).astype(np.float32) * 2.0).to(dev)
        attn = torch.softmax(logits, -1).to(torch.bfloat16).view(b, q, M, L, P).contiguous()
        grad = torch.from_numpy(rng.randn(b, q, M * D).astype(np.float32)).to(dev, torch.bfloat16)
        forms[form] = (value, TRAIN_LEVELS, torch.from_numpy(loc.astype(np.float32)).to(dev), attn, grad)
    return forms


def _serving_loc_inputs(dev):
    """K4's and K4b's serving-encoder inputs as phase 2c makes them: Q = S =
    8617 samples around each query's pixel, a quarter on pixel centres, 2% far
    outside; returns the standard entry's (value, levels, loc, attn) and the
    channel-major entry's (valueT, levels, loc_cm, attn_cm)."""
    import torch

    rng = np.random.RandomState(2)
    s = sum(h * w for h, w in LEVELS)
    wh = np.asarray([[w, h] for h, w in LEVELS], np.float64)[None, None, None, :, None, :]
    value = rng.randn(B, s, M, D)
    start = 0
    for h, w in LEVELS:
        value[:, start + np.arange(h) * w + (w - 1)] = 0.0
        start += h * w
    value = torch.from_numpy(value.astype(np.float32)).to(dev, torch.bfloat16)
    grid = np.concatenate([np.stack(np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(h) + 0.5) / h), -1)
                           .reshape(-1, 2) for h, w in LEVELS])
    loc = grid[None, :, None, None, None, :] + rng.randn(B, s, M, L, P, 2) * 3.0 / wh
    centre = rng.rand(B, s, M, L, P) < 0.25
    loc[centre] = ((np.floor(loc * wh) + 0.5) / wh)[centre]
    far = rng.rand(B, s, M, L, P) < 0.02
    loc[far] = rng.choice([-4.0, 5.0], size=(int(far.sum()), 2))
    loc = torch.from_numpy(loc.astype(np.float32)).to(dev)
    logits = torch.from_numpy(rng.randn(B, s, M, L * P).astype(np.float32) * 2.0).to(dev)
    attn = torch.softmax(logits, -1).to(torch.bfloat16).view(B, s, M, L, P).contiguous()
    cm = (value.view(B, s, M * D).transpose(1, 2).contiguous(), LEVELS,
          loc.permute(0, 2, 3, 4, 5, 1).contiguous(), attn.permute(0, 2, 3, 4, 1).contiguous())
    return (value, LEVELS, loc, attn), cm


def run_one(root: Path, reps: int, keys=None) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from vnext_tpu_torch.ops import encoder_epilogue as epi
    from vnext_tpu_torch.ops import ms_deform_attn as msda
    from vnext_tpu_torch.ops import stem_conv as stem
    from vnext_tpu_torch.tools import exp_dynstore

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    if not Path(msda.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {msda.__file__}, not the tree under {root}")
    dev = torch.device("cuda", 0)
    enc, dec, stems, epilogue, backward = _inputs(dev)
    calls = {"k1_encoder": (msda.ms_deform_attn, enc), "k1_decoder": (msda.ms_deform_attn, dec)}
    calls.update({f"k2_{name}": (stem.stem_conv7x7s2_bn_relu, args) for name, args in stems.items()})
    calls["k3"] = (epi.encoder_epilogue, epilogue)
    calls.update({f"k5_{form}": (msda.ms_deform_attn_v9_backward, args) for form, args in backward.items()})
    k4 = lambda value, levels, loc, attn: msda.ms_deform_attn_standard(value, levels, loc, attn, "pallas_v9")
    calls.update({f"k4_train_{form}": (k4, args[:4]) for form, args in backward.items()})
    serving, cm = _serving_loc_inputs(dev)
    calls["k4_serving_encoder"] = (k4, serving)
    calls["k4b"] = (msda.ms_deform_attn_cm, cm)
    calls["k9"] = (exp_dynstore.dynstore, tuple(a.to(dev) for a in exp_dynstore.probe_inputs()))
    if keys:
        calls = {k: v for k, v in calls.items() if k in keys}
    times, stream, device = {}, {}, {}
    with torch.no_grad():
        for key, (fn, args) in calls.items():
            times[key] = _time_ms(lambda: fn(*args), reps)
            stream[key] = _time_ms(lambda: fn(*args), reps, calls=20)
        if "k9" in calls:
            device["k9"] = device_ms(lambda: calls["k9"][0](*calls["k9"][1]), "dynstore_kernel")
    return {"root": str(root), "device": torch.cuda.get_device_name(0), "ms": times, "stream_ms": stream,
            "device_ms": device}


def device_ms(fn, kernel: str, calls: int = 20) -> float:
    """Device time per call of the kernels whose name holds ``kernel``, by
    ``torch.profiler`` over ``calls`` calls after one of warm-up: a kernel's own
    time where its wrapper's host work is longer (``chip_smoke.py`` uses it too)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and kernel in e.key]
    if not events:
        raise RuntimeError(f"the profiler saw no kernel named {kernel}")
    return sum(e.self_device_time_total for e in events) / 1e3 / calls


def strip_atomics(root: Path, dst: Path) -> Path:
    """A copy of ``root``'s package under ``dst`` whose MSDA backward source has
    every line that calls ``atomicAdd`` deleted (the value gradient's
    reductions); returns ``dst``."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "vnext_tpu_torch", dst / "vnext_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    src = dst / "vnext_tpu_torch" / "csrc" / "ms_deform_attn_bwd.cu"
    lines = src.read_text().splitlines(keepends=True)
    kept = [ln for ln in lines if "atomicAdd(" not in ln]
    if len(kept) == len(lines):
        raise SystemExit(f"{src}: no atomicAdd line to remove")
    src.write_text("".join(kept))
    return dst


def sass_report(root: Path) -> dict:
    """K1's, K4's and K4b's 128-bit global loads, K3's HGMMA instructions and
    K5's reductions in the SASS of ``root``'s library as built (``cuobjdump``)."""
    from vnext_tpu_torch import _build

    if not Path(_build.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {_build.__file__}, not the tree under {root}: run this file from there")
    lib = _build.load_library()
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib.path)], capture_output=True, text=True,
                          check=True).stdout
    report = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if "msda_fwd_kernel" in name or "msda_fwd_loc" in name:
            loads = [len(re.findall(r"LDG\.E[.\w]*\.128", seg)) for seg in re.split(r"\bFFMA\b", block)]
            instructions = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?[A-Z]", block))
            report[name] = {"ldg128": sum(loads), "between_ffmas": [n for n in loads if n],
                            "instructions": instructions}
        elif "encoder_epilogue_kernel" in name or "msda_bwd_kernel" in name:
            pattern = r"\b(HGMMA\.[\w.]+)" if "encoder" in name else r"\b((?:REDG?|ATOMG?)\.[\w.]+)"
            ops = {}
            for op in re.findall(pattern, block):
                ops[op] = ops.get(op, 0) + 1
            report[name] = ops
    return report


def _run(label: str, root: Path, reps: int, keys=None) -> dict:
    # run as a file, so that the package is imported from ``root`` alone
    cmd = [sys.executable, str(Path(__file__).resolve()), "--one", "--root", str(root.resolve()),
           "--reps", str(reps)]
    if keys:
        cmd += ["--keys", ",".join(keys)]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout + proc.stderr)
        raise SystemExit(f"the {label} run failed ({proc.returncode})")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps({"run": label, **line}), flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of the parent tree: run parent, change, change, parent")
    ap.add_argument("--root", type=Path, default=HERE, help="with --one: the tree to time; with --sass: "
                                                            "the tree whose library to read")
    ap.add_argument("--one", action="store_true", help="time one tree and print its JSON line")
    ap.add_argument("--keys", help="with --one: a comma-separated subset of the kernels to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--atomics-off", action="store_true",
                    help="also time K5 of each tree with its value-gradient reductions removed")
    ap.add_argument("--sass", action="store_true",
                    help="report K1's, K3's, K4's, K4b's and K5's SASS counts in this tree")
    args = ap.parse_args(argv)
    if args.sass:
        sys.path.insert(0, str(args.root))
        print(json.dumps(sass_report(args.root)))
        return 0
    if args.one:
        print(json.dumps(run_one(args.root, args.reps, args.keys.split(",") if args.keys else None)),
              flush=True)
        return 0
    if args.parent is None:
        ap.error("give --parent (or --one)")
    trees = {"parent": args.parent, "change": HERE}
    keys = {label: None for label in trees}
    if args.atomics_off:
        for label, root in list(trees.items()):
            trees[f"{label}_atomics_off"] = strip_atomics(root, STRIPPED / label)
            keys[f"{label}_atomics_off"] = ["k5_encoder", "k5_decoder"]
    order = ["parent", "change", "change", "parent"]
    if args.atomics_off:
        order = ["parent", "parent_atomics_off", "change", "change_atomics_off",
                 "change_atomics_off", "change", "parent_atomics_off", "parent"]
    runs = {label: [] for label in trees}
    for label in order:
        runs[label].append(_run(label, trees[label], args.reps, keys[label]))
    summary = {}
    for metric in ("ms", "stream_ms", "device_ms"):
        for key in runs["change"][0].get(metric, {}):
            par = statistics.median(r[metric][key] for r in runs["parent"])
            chg = statistics.median(r[metric][key] for r in runs["change"])
            summary[f"{key} {metric}"] = {"parent": par, "change": chg, "ratio": chg / par}
            for label in ("parent", "change"):
                off = runs.get(f"{label}_atomics_off")
                if off and key in off[0][metric]:
                    with_ = par if label == "parent" else chg
                    without = statistics.median(r[metric][key] for r in off)
                    summary[f"{key} {metric}"][f"{label}_atomics_off"] = without
                    summary[f"{key} {metric}"][f"{label}_reduction_share"] = 1.0 - without / with_
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
