"""Model analysis CLI (reference surface: tools/analyze_model.py — FLOPs,
activations, parameters, structure); counterpart of the JAX package's
``tools/analyze_model.py``:

    python -m vnext_tpu_torch.tools.analyze_model --config-file configs/idol/ytvis19_r50.yaml \\
        [--tasks parameter flop structure] [--image-size 480 864] [MODEL.DEVICE cpu]

The model is what ``build_model`` builds from the config, with seeded weights,
on the card unless the config says ``MODEL.DEVICE cpu`` (with no CUDA device
visible it raises). ``flop`` counts one frame's inference with
``FlopCounterMode`` and prints the hand-written kernels' share (their
operators' formulas) beside the total.
"""

from __future__ import annotations

import argparse
import sys

from ..config import add_idol_config, add_seqformer_config, get_cfg
from ..models import build_model
from ..utils.analysis import flop_count, parameter_count, parameter_count_table
from .export_model import example_inputs, inference_fn
from .train_net import resolve_device


def analyze(cfg, tasks=("parameter", "flop", "structure"), image_size=None) -> dict:
    """The requested analyses of ``cfg``'s model: ``parameters``, ``table``,
    and ``flops`` / ``kernel_flops`` (the ``vnext.*`` operators' part) of one
    frame's inference at ``image_size`` (default ``TPU.TEST_IMAGE_SIZE``)."""
    device = resolve_device(cfg)
    model = build_model(cfg, device=device)
    h, w = image_size or cfg.TPU.TEST_IMAGE_SIZE
    out = {}
    if "parameter" in tasks:
        out["parameters"] = parameter_count(model)
    if "structure" in tasks:
        out["table"] = parameter_count_table(model)
    if "flop" in tasks:
        cost = flop_count(inference_fn(model), *example_inputs(model, 1, h, w, device))
        out["flops"] = cost["flops"]
        out["by_operator"] = cost["by_operator"]
        out["kernel_flops"] = sum(n for op, n in cost["by_operator"].items() if op.startswith("vnext."))
    out["image_size"] = (h, w)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", default="")
    parser.add_argument("--tasks", nargs="+", default=["parameter", "flop", "structure"],
                        choices=["parameter", "flop", "structure"])
    parser.add_argument("--image-size", type=int, nargs=2, default=None)
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)

    cfg = get_cfg()
    add_idol_config(cfg)
    add_seqformer_config(cfg)
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)

    out = analyze(cfg, args.tasks, args.image_size)
    h, w = out["image_size"]
    if "parameters" in out:
        print(f"total parameters: {out['parameters'] / 1e6:.2f}M")
    if "table" in out:
        print(out["table"])
    if "flops" in out:
        print(f"inference flops @ {h}x{w}: {out['flops'] / 1e9:.2f} GFLOPs, of which the hand-written "
              f"kernels' operators {out['kernel_flops'] / 1e9:.2f} GFLOPs "
              f"({out['flops'] / 1e9 - out['kernel_flops'] / 1e9:.2f} GFLOPs without their formulas)")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
