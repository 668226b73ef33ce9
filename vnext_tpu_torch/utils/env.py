"""Environment helpers (reference surface: detectron2/utils/env.py seed_all_rng,
collect_env.py collect_env_info), the port's copy of ``vnext_tpu.utils.env``."""

from __future__ import annotations

import datetime
import os
import random
import shutil
import subprocess
import sys
from typing import Optional

import numpy as np


def seed_all_rng(seed: Optional[int] = None) -> int:
    """Seed python's and numpy's global generators and ``PYTHONHASHSEED``;
    returns the seed. torch's global generator is left alone: the port passes
    explicit ``torch.Generator``s.

    The reference derives a seed from time+pid when none is given
    (env.py:seed_all_rng); we keep that behavior.
    """
    if seed is None or seed < 0:
        seed = (
            os.getpid()
            + int(datetime.datetime.now().strftime("%S%f"))
            + int.from_bytes(os.urandom(2), "big")
        ) % (2**31)
    random.seed(seed)
    np.random.seed(seed % (2**32))
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed


def _nvcc_version() -> str:
    from .._build import _nvcc

    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, timeout=30).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"
    return out.strip().splitlines()[-1] if out.strip() else "unavailable"


def collect_env_info() -> str:
    """Version/platform dump for logs and bug reports: python, torch, its CUDA,
    ``nvcc`` (which builds the kernels) and the card."""
    import torch

    import vnext_tpu_torch

    lines = [
        f"python: {sys.version.replace(chr(10), ' ')}",
        f"platform: {sys.platform}",
        f"torch: {torch.__version__}",
        f"torch CUDA: {torch.version.cuda}",
        f"nvcc: {_nvcc_version()}",
    ]
    if torch.cuda.is_available():
        lines.append(f"devices: {[torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]}")
    else:
        lines.append("devices: no CUDA device is visible")
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        lines.append(f"nvidia-smi: {smi.stdout.strip() or smi.stderr.strip()}")
    lines.append(f"numpy: {np.__version__}")
    lines.append(f"vnext_tpu_torch: {vnext_tpu_torch.__version__}")
    return "\n".join(lines)
