"""ctypes binding of the evaluator's native kernels (``csrc/rle_ops.c``).

Counterpart of ``vnext_tpu.evaluation.native``. The C source is compiled on
first use with the host's C compiler (``cc -O3 -shared``) into the
repository's gitignored ``build/vnext_tpu_torch/``, under a name that carries a
hash of the source, so an edited source rebuilds and a stale library is never
loaded; the library is written under a temporary name and renamed into place,
so processes that build at once never load a half-written file. Without a
compiler the evaluator runs its Python path; the log says which path runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .rle import rle_counts

logger = logging.getLogger("vnext_tpu_torch")

SOURCE = Path(__file__).resolve().parent / "csrc" / "rle_ops.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vnext_tpu_torch"
CFLAGS = ("-O3", "-fPIC", "-shared")


@functools.lru_cache(maxsize=None)
def load() -> Optional[ctypes.CDLL]:
    """The native library, built if needed; None (logged) without a compiler."""
    digest = hashlib.sha256(" ".join(CFLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"rle_ops_{digest}.so"
    try:
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["cc", *CFLAGS, "-o", tmp, str(SOURCE)], check=True, capture_output=True)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.CalledProcessError) as e:
        logger.warning("evaluation: native rle_ops unavailable (%s); the Python path runs", e)
        return None
    i64, u8, f64 = (ctypes.POINTER(t) for t in (ctypes.c_int64, ctypes.c_uint8, ctypes.c_double))
    lib.tube_iou_matrix.argtypes = [i64, i64, i64, i64, i64, u8,
                                    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f64]
    lib.tube_iou_matrix.restype = None
    lib.match_greedy.argtypes = [f64, ctypes.c_int64, ctypes.c_int64, u8, u8, f64, ctypes.c_int64, u8, u8]
    lib.match_greedy.restype = None
    logger.info("evaluation: native rle_ops loaded from %s", so)
    return lib


def available() -> bool:
    return load() is not None


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def tube_iou_matrix_native(
    det_segms: List[List[Optional[dict]]],
    gt_segms: List[List[Optional[dict]]],
    gt_iscrowd: Sequence[bool],
) -> np.ndarray:
    """[D, G] tube IoU over aligned per-frame lists of RLEs (None: absent)."""
    lib = load()
    if lib is None:
        raise RuntimeError("the native rle_ops library is not available")
    d, g = len(det_segms), len(gt_segms)
    t = len(det_segms[0]) if d else (len(gt_segms[0]) if g else 0)
    chunks: List[np.ndarray] = []
    total = 0

    def intern(segms):
        nonlocal total
        off = np.zeros((len(segms), t), np.int64)
        ln = np.zeros((len(segms), t), np.int64)
        for i, frames in enumerate(segms):
            for f, s in enumerate(frames):
                if s is None:
                    continue
                arr = np.ascontiguousarray(rle_counts(s), dtype=np.int64)
                chunks.append(arr)
                off[i, f] = total
                ln[i, f] = len(arr)
                total += len(arr)
        return off, ln

    det_off, det_len = intern(det_segms)
    gt_off, gt_len = intern(gt_segms)
    buf = np.concatenate(chunks).astype(np.int64) if chunks else np.zeros((1,), np.int64)
    crowd = np.ascontiguousarray(gt_iscrowd, dtype=np.uint8)
    out = np.zeros((d, g), np.float64)
    if d and g:
        lib.tube_iou_matrix(
            _ptr(buf, ctypes.c_int64),
            _ptr(det_off.reshape(-1), ctypes.c_int64), _ptr(det_len.reshape(-1), ctypes.c_int64),
            _ptr(gt_off.reshape(-1), ctypes.c_int64), _ptr(gt_len.reshape(-1), ctypes.c_int64),
            _ptr(crowd, ctypes.c_uint8), d, g, t, _ptr(out.reshape(-1), ctypes.c_double),
        )
    return out


def match_greedy_native(
    iou: np.ndarray,
    gt_ignore: Sequence[bool],
    thrs: np.ndarray,
    iscrowd: Sequence[bool],
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy matching at every threshold: (matched [T, D], ignored [T, D]).
    Rows of ``iou`` score-sorted, its columns ignore-last; only crowd ground
    truths may be matched twice."""
    lib = load()
    if lib is None:
        raise RuntimeError("the native rle_ops library is not available")
    iou = np.ascontiguousarray(iou, dtype=np.float64)
    d, g = iou.shape
    ign = np.ascontiguousarray(gt_ignore, dtype=np.uint8)
    crowd = np.ascontiguousarray(iscrowd, dtype=np.uint8)
    if ign.shape != (g,) or crowd.shape != (g,):
        raise ValueError(f"gt_ignore {ign.shape} and iscrowd {crowd.shape} must have {g} entries")
    th = np.ascontiguousarray(thrs, dtype=np.float64)
    matched = np.zeros((len(th), d), np.uint8)
    ignored = np.zeros((len(th), d), np.uint8)
    lib.match_greedy(
        _ptr(iou.reshape(-1), ctypes.c_double), d, g,
        _ptr(ign, ctypes.c_uint8), _ptr(crowd, ctypes.c_uint8),
        _ptr(th, ctypes.c_double), len(th),
        _ptr(matched.reshape(-1), ctypes.c_uint8),
        _ptr(ignored.reshape(-1), ctypes.c_uint8),
    )
    return matched.astype(bool), ignored.astype(bool)
