"""Time K1 (the fused MSDA forward, both forms) and K2 (the stem, serving and
train shapes) of two checkouts of the port in one process tree, in turns.

    python -m vnext_tpu_torch.tools.kernel_ab --parent build/parent

runs the timing once per tree in the order parent, change, change, parent, each
in its own process that imports ``vnext_tpu_torch`` from that tree (the
parent's kernels build into the parent's own ``build/``), and prints one JSON
line per run and a summary with each kernel's median per tree and the ratio
change / parent. The inputs are ``chip_smoke.py`` phase 2a's at IDOL-R50's
serving shapes (B = 10, 480x864: the encoder's point form at Q = S = 8617 and
the decoder's box form at Q = 300) and phase 2b's stem input at the train shape
[4, 512, 640, 3], made from the same seed in every run. Times are CUDA events
on one card, the median over ``--reps`` samples after warm-up: ``ms`` times one
call per event pair, as ``chip_smoke.py`` does, so it includes the wrapper's
host work when the card waits for it; ``stream_ms`` times 20 calls between two
events, per call, so the host runs ahead wherever the kernel takes longer than
the wrapper.

    python -m vnext_tpu_torch.tools.kernel_ab --root build/parent --one

times one tree and prints its JSON line (what each turn above runs).

    python -m vnext_tpu_torch.tools.kernel_ab --sass

prints, for this tree's K1 (``msda_fwd_kernel``) as compiled, its 128-bit
global loads and how many of them each stretch between two f32 FMAs issues.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

LEVELS = ((60, 108), (30, 54), (15, 27), (8, 14))
B, M, D, L, P = 10, 8, 32, 4, 4
STEM_SHAPES = {"serving": (10, 480, 864, 3), "train": (4, 512, 640, 3)}
HERE = Path(__file__).resolve().parents[2]


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
    return enc, dec, stems


def run_one(root: Path, reps: int) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from vnext_tpu_torch.ops import ms_deform_attn as msda
    from vnext_tpu_torch.ops import stem_conv as stem

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA device")
    if not Path(msda.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {msda.__file__}, not the tree under {root}")
    dev = torch.device("cuda", 0)
    enc, dec, stems = _inputs(dev)
    calls = {"k1_encoder": (msda.ms_deform_attn, enc), "k1_decoder": (msda.ms_deform_attn, dec)}
    calls.update({f"k2_{name}": (stem.stem_conv7x7s2_bn_relu, args) for name, args in stems.items()})
    times, stream = {}, {}
    with torch.no_grad():
        for key, (fn, args) in calls.items():
            times[key] = _time_ms(lambda: fn(*args), reps)
            stream[key] = _time_ms(lambda: fn(*args), reps, calls=20)
    return {"root": str(root), "device": torch.cuda.get_device_name(0), "ms": times, "stream_ms": stream}


def sass_report() -> dict:
    """K1's 128-bit global loads in the built library's SASS (``cuobjdump``)."""
    from vnext_tpu_torch._build import _nvcc, load_library

    lib = load_library()
    cuobjdump = Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib.path)], capture_output=True, text=True,
                          check=True).stdout
    report = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if "msda_fwd_kernel" in name:
            loads = [len(re.findall(r"LDG\.E[.\w]*\.128", seg)) for seg in re.split(r"\bFFMA\b", block)]
            report[name] = {"ldg128": sum(loads), "between_ffmas": [n for n in loads if n]}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="root of the parent tree: run parent, change, change, parent")
    ap.add_argument("--root", type=Path, default=HERE, help="with --one: the tree to time")
    ap.add_argument("--one", action="store_true", help="time one tree and print its JSON line")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true", help="report K1's 128-bit loads in this tree's SASS")
    args = ap.parse_args(argv)
    if args.sass:
        print(json.dumps(sass_report()))
        return 0
    if args.one:
        print(json.dumps(run_one(args.root, args.reps)), flush=True)
        return 0
    if args.parent is None:
        ap.error("give --parent (or --one)")
    order = [("parent", args.parent), ("change", HERE), ("change", HERE), ("parent", args.parent)]
    runs = {"parent": [], "change": []}
    for label, root in order:
        # run as a file, so that the package is imported from ``root`` alone
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one", "--root", str(root.resolve()),
             "--reps", str(args.reps)],
            cwd=root, capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"the {label} run failed ({proc.returncode})")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"run": label, **line}), flush=True)
        runs[label].append(line)
    summary = {}
    for metric in ("ms", "stream_ms"):
        for key in runs["change"][0][metric]:
            par = statistics.median(r[metric][key] for r in runs["parent"])
            chg = statistics.median(r[metric][key] for r in runs["change"])
            summary[f"{key} {metric}"] = {"parent": par, "change": chg, "ratio": chg / par}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
