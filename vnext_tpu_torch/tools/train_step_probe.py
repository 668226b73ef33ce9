"""Step time and peak memory of a training run through ``train_net``, on one NVIDIA GPU.

    python -m vnext_tpu_torch.tools.train_step_probe \\
        --config-file configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml \\
        SOLVER.IMS_PER_BATCH 16 SOLVER.MAX_ITER 3 DATASETS.TRAIN "('coco_synthetic_tiny',)" DATASETS.TEST "()" \\
        OUTPUT_DIR output/probe

runs ``tools/train_net.main`` in-process on the same command line (the
synthetic COCO set is registered where it is named) and prints one JSON line:
the card's name and power limit, each step's time with the card synchronized
before and after it, and the peak device memory of the run; or, when a step
runs out of device memory, ``"fit": false`` with the memory allocated at that
point. Nothing of the run is changed: the probe wraps the trainer's step.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from ..engine.trainer import VISTrainer
from . import train_net


def card() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(0)


def main(argv=None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("train_step_probe measures the card: no CUDA device is visible")
    steps_ms = []
    run_step = VISTrainer.run_step

    def timed(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_step(self)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)

    torch.cuda.reset_peak_memory_stats()
    VISTrainer.run_step = timed
    try:
        train_net.main(argv)
        out = {"fit": True}
    except torch.cuda.OutOfMemoryError as e:
        out = {"fit": False, "allocated_gib": torch.cuda.memory_allocated() / 2 ** 30, "error": str(e)[:300]}
    finally:
        VISTrainer.run_step = run_step
    out.update(card=card(), step_ms=steps_ms, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
