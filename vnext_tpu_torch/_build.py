"""Build and load the hand-written Hopper kernels in ``csrc/``.

The kernels are plain CUDA C++ with a C interface (no PyTorch headers), compiled
on first use with ``nvcc`` for ``sm_90a`` into one shared library under
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
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
    """Build (if needed) and load the kernel library; cached per process."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libvnext_kernels_{_digest()}.so"
    log = ""
    t0 = time.perf_counter()
    if not out.exists():
        cu = [str(s) for s in _sources() if s.suffix == ".cu"]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    return Library(lib=lib, path=out, build_log=log, build_seconds=seconds)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    signatures = {
        # value, offsets, ref, logits, level_hw_start, out, B, Q, S, M, L, P, ref_dim, stream
        "vnext_msda_fwd": [p, p, p, p, p, p, i, i, i, i, i, i, i, p],
        # x, w, scale, bias, out, B, H, W, stream
        "vnext_stem_conv": [p, p, p, p, p, i, i, i, p],
        # attn, src, ln1_w, ln1_b, w1, b1, w2, b2, ln2_w, ln2_b, out, N, F, stream
        "vnext_encoder_epilogue": [p, p, p, p, p, p, p, p, p, p, p, i, i, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {code}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
