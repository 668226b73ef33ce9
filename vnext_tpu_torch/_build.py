"""Build and load the hand-written Hopper kernels in ``csrc/``.

The kernels are plain CUDA C++ with a C interface (no PyTorch headers), compiled
on first use with ``nvcc`` for ``sm_90a`` (one process per source, in parallel)
and linked into one shared library under
``build/vnext_tpu_torch/`` at the repository root, and loaded with ``ctypes``.
The library's file name carries a hash of the sources and flags, so an edited
source rebuilds and a stale library is never loaded.

Each C entry point launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception. Nothing here runs at import time: this module imports on machines
with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "vnext_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


@dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how many
    times its wrapper has launched it (the wrapper adds one per launch)."""

    name: str
    source: str      # path in the repository
    replaces: str    # file:line of the TPU (Pallas) kernel it replaces
    launches: int = 0


@dataclass
class Library:
    lib: ctypes.CDLL
    path: Path
    build_log: str
    build_seconds: float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    """Build (if needed) and load the kernel library; cached per process. Each
    source compiles in its own ``nvcc``, all started together; one more links
    the objects into the shared library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libvnext_kernels_{_digest()}.so"
    log = ""
    t0 = time.perf_counter()
    if not out.exists():
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            cu = [s for s in _sources() if s.suffix == ".cu"]
            objs = [str(Path(tmp) / f"{s.stem}.o") for s in cu]
            cmds = [[_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", o, str(s)] for s, o in zip(cu, objs)]
            procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for c in cmds]
            outputs = [p.communicate()[0] for p in procs]
            log = "".join(outputs)
            for cmd, proc, text in zip(cmds, procs, outputs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
            lib_tmp = str(Path(tmp) / out.name)
            link = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", lib_tmp, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(lib_tmp, out)  # atomic: a concurrent loader sees all or nothing
    seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return Library(lib=lib, path=out, build_log=log, build_seconds=seconds)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    signatures = {
        # value, offsets, ref, logits, level_hw_start, out, B, Q, S, M, L, P, ref_dim, stream
        "vnext_msda_fwd": [p, p, p, p, p, p, i, i, i, i, i, i, i, p],
        # value, loc, attn, level_hw_start, out, B, Q, S, M, L, P, stream
        "vnext_msda_fwd_loc": [p, p, p, p, p, i, i, i, i, i, i, p],
        # the same, channel-major locations / weights / output
        "vnext_msda_fwd_loc_cm": [p, p, p, p, p, i, i, i, i, i, i, p],
        # x, r, out, B, rows, W, T, D, block_rows, stream
        "vnext_dynstore": [p, p, p, i, i, i, i, i, i, p],
        # B, rows, W, T, stream: an empty kernel on K9's grid (its launch floor)
        "vnext_dynstore_empty": [i, i, i, i, p],
        # value, loc, attn, grad, level_hw_start, dvalue_f32, dloc, dattn, dvalue,
        # B, Q, S, M, L, P, stream
        "vnext_msda_bwd": [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p],
        # x, w, scale, bias, out, B, H, W, stream
        "vnext_stem_conv": [p, p, p, p, p, i, i, i, p],
        # attn, src, ln1_w, ln1_b, packed w1 / w2, b1, b2, ln2_w, ln2_b, out, N, F, stream
        "vnext_encoder_epilogue": [p, p, p, p, p, p, p, p, p, p, i, i, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)   # a symbol the sources lack raises here, at load
        fn.argtypes = argtypes
        fn.restype = i


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would need the backward of an inference-only kernel."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is inference-only and has no backward: call it under torch.no_grad() "
            "or torch.inference_mode(); a module in train mode takes the unfused path")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
