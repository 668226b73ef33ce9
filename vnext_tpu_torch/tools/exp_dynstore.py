"""Probe: read-modify-write accumulate into an output block at a row offset
computed from the data, revisiting the block across steps (K9).

Counterpart of ``tools/exp_dynstore.py``: that probe checks that a Pallas TPU
kernel can do ``out[b, r0*D : r0*D + HB*D] += x[b, :HB*D] + 1`` with ``r0``
computed in the kernel, over T grid steps that all write the same output block.
Here :func:`dynstore` runs ``csrc/dynstore.cu`` on a CUDA tensor and
:func:`dynstore_plain` on a CPU tensor. Per batch element b and step t, in order:

    r0 = (sum_i int32(r[b, 8t + i, 0])) // T
    out[b, start : start + HB*D, :] += float(x[b, :HB*D, :]) + 1

with ``out`` zeroed before t = 0 and ``start = r0 * D`` placed as the probe's
``pl.ds`` places it when the JAX probe runs in interpret mode: a negative start
counts from the end of the H*D rows, and the block is clamped inside them.

    python -m vnext_tpu_torch.tools.exp_dynstore               # on the card
    python -m vnext_tpu_torch.tools.exp_dynstore --device cpu  # the plain version

prints ``maxdiff`` against a numpy loop, as the JAX probe does.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .._build import Kernel, check, load_library, stream_handle

H, D, W, T, HB = 16, 8, 128, 4, 4
ROWS_PER_STEP = 8   # rows of r each step reads (the probe's r block)
MAX_STEPS = 12288   # one int of shared memory per step, within the 48 KB a launch gets by default

KERNEL = Kernel(
    name="dynstore",
    source="vnext_tpu_torch/csrc/dynstore.cu",
    replaces="tools/exp_dynstore.py:22",
)


def _check_args(x, r, n_steps, d, block_rows):
    if x.dim() != 3 or r.dim() != 3 or r.shape[0] != x.shape[0] or r.shape[2] != x.shape[2]:
        raise ValueError(f"x must be [B, H*D, W] and r [B, T*8, W], got {tuple(x.shape)}, {tuple(r.shape)}")
    if r.shape[1] != ROWS_PER_STEP * n_steps:
        raise ValueError(f"r has {r.shape[1]} rows for {n_steps} steps of {ROWS_PER_STEP}")
    if x.shape[1] % d or block_rows * d > x.shape[1]:
        raise ValueError(f"{x.shape[1]} rows do not hold blocks of {block_rows} x {d}")


def _check_grid(b, rows, n_steps):
    """What the kernel's grid and shared memory take: the batch on grid z, rows
    in fours on grid y, one int of shared memory per step."""
    if b > 65535 or -(-rows // 4) > 65535:
        raise ValueError(f"the dynstore kernel takes B <= 65535 and rows <= 262140, got {b}, {rows}")
    if n_steps > MAX_STEPS:
        raise ValueError(f"the dynstore kernel places at most {MAX_STEPS} steps in shared memory, got {n_steps}")


def block_start(start: torch.Tensor, rows: int, block: int) -> torch.Tensor:
    """Where the probe's ``pl.ds(start, block)`` lands among ``rows`` rows: a
    negative start counts from the end, then the block is clamped inside."""
    return torch.where(start < 0, start + rows, start).clamp(0, rows - block)


def dynstore_plain(x, r, n_steps: int = T, d: int = D, block_rows: int = HB):
    """Plain PyTorch version: [B, H*D, W] f32."""
    _check_args(x, r, n_steps, d, block_rows)
    b, rows, _ = x.shape
    blk = block_rows * d
    add = x[:, :blk].float() + 1.0
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t in range(n_steps):
        s = r[:, ROWS_PER_STEP * t:ROWS_PER_STEP * (t + 1), 0].to(torch.int32).sum(1)
        start = block_start(torch.div(s, n_steps, rounding_mode="floor") * d, rows, blk)
        for i in range(b):
            j = int(start[i])
            out[i, j:j + blk] += add[i]
    return out


def dynstore(x, r, n_steps: int = T, d: int = D, block_rows: int = HB):
    """K9 on a CUDA tensor (x bf16, r f32), the plain version on a CPU one."""
    _check_args(x, r, n_steps, d, block_rows)
    if x.device.type == "cpu":
        return dynstore_plain(x, r, n_steps, d, block_rows)
    if x.device.type != "cuda":
        raise ValueError(f"dynstore: no implementation for device {x.device}")
    if x.dtype != torch.bfloat16 or r.dtype != torch.float32:
        raise TypeError(f"the dynstore kernel takes x bf16 and r f32, got {x.dtype}, {r.dtype}")
    if r.device != x.device or not (x.is_contiguous() and r.is_contiguous()):
        raise ValueError("the dynstore kernel needs x and r contiguous on one device")
    b, rows, w = x.shape
    _check_grid(b, rows, n_steps)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = load_library().lib
    with torch.cuda.device(x.device):
        code = lib.vnext_dynstore(x.data_ptr(), r.data_ptr(), out.data_ptr(), b, rows, w,
                                  n_steps, d, block_rows * d, stream_handle(x.device))
    check(code, "dynstore")
    KERNEL.launches += 1
    return out


def empty_launch(x, n_steps: int = T) -> None:
    """An empty kernel on K9's grid, block and shared memory for ``x`` [B, H*D,
    W] on the card: the time of the launch alone, K9's floor at small sizes. It
    is not K9 and leaves K9's counter alone."""
    b, rows, w = x.shape
    _check_grid(b, rows, n_steps)
    with torch.cuda.device(x.device):
        code = load_library().lib.vnext_dynstore_empty(b, rows, w, n_steps, stream_handle(x.device))
    check(code, "dynstore (empty launch)")


def probe_inputs(step_starts=(0, 1, 2, 0), seed: int = 0):
    """The probe's inputs: x [2, H*D, W] bf16 from ``seed`` and r whose step t
    picks row-chunk start ``step_starts[t]`` (the probe's t % 3)."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(2, H * D, W).astype(np.float32)).to(torch.bfloat16)
    r = torch.zeros(2, T * ROWS_PER_STEP, W)
    for t, s in enumerate(step_starts):
        r[:, t * ROWS_PER_STEP, :] = float(s * T)
    return x, r


def reference(x, r) -> np.ndarray:
    """The probe's numpy loop, with the same placement of the block."""
    xf, rn = x.float().numpy(), r.numpy()
    want = np.zeros(xf.shape, np.float32)
    for b in range(xf.shape[0]):
        for t in range(T):
            s = int(rn[b, ROWS_PER_STEP * t:ROWS_PER_STEP * (t + 1), 0].astype(np.int32).sum()) // T
            j = int(block_start(torch.tensor(s * D), H * D, HB * D))
            want[b, j:j + HB * D] += xf[b, :HB * D] + 1.0
    return want


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the kernel) or cpu (the plain version)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible; pass --device cpu for the plain version")
    x, r = probe_inputs()
    out = dynstore(x.to(dev), r.to(dev))
    diff = float(np.abs(out.cpu().numpy() - reference(x, r)).max())
    print("device:", dev)
    print("maxdiff:", diff)
    assert diff < 1e-5, "dynamic RMW store mismatch"
    print("OK: dynamic-offset read-modify-write store works")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
