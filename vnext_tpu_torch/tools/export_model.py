"""Export a model's clip inference as a ``torch.export`` program (``.pt2``).

Counterpart of ``tools/export_model.py`` (the JAX package exports StableHLO;
reference surface: tools/deploy/export_model.py), with the same flags:

    python -m vnext_tpu_torch.tools.export_model --config-file configs/idol/ytvis19_r50.yaml \\
        --output out/idol.pt2 [--height 480 --width 864 --frames 10] [MODEL.WEIGHTS model.pth]

It exports ``type(model).inference`` of whatever ``build_model`` builds from
the config, at static shapes: IDOL and MaskFormer take a clip of ``--frames``
frames [T, H, W, 3] and their sizes [T, 2]; SeqFormer the clip as one video
[1, T, H, W, 3] and its size [1, 2]. The graph holds the hand-written kernels
as ``torch.ops.vnext`` operators. The model runs on the card unless the
config says ``MODEL.DEVICE cpu``; with no CUDA device visible it raises.
Load the file with ``vnext_tpu_torch.export.load_exported``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..checkpoint.checkpointer import load_weights
from ..config import add_idol_config, add_seqformer_config, get_cfg
from ..export import export_program, save_exported
from ..models import build_model
from .train_net import resolve_device


def example_inputs(model, frames: int, height: int, width: int, device):
    """Zero images and their full sizes in the layout ``type(model).inference`` takes."""
    images = torch.zeros(frames, height, width, 3, device=device)
    sizes = torch.tensor([[height, width]] * frames, dtype=torch.int32, device=device)
    if type(model).__name__ == "SeqFormer":
        return images[None], sizes[:1]
    return images, sizes


def inference_fn(model):
    """``type(model).inference`` bound to ``model``, as the exported function."""
    return lambda *args: type(model).inference(model, *args)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=864)
    parser.add_argument("--frames", type=int, default=10)
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)

    cfg = get_cfg()
    add_idol_config(cfg)
    add_seqformer_config(cfg)
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)

    device = resolve_device(cfg)
    model = build_model(cfg, device=device)
    if cfg.MODEL.WEIGHTS:
        load_weights(cfg.MODEL.WEIGHTS, model)
    t, h, w = args.frames, args.height, args.width
    exported = export_program(inference_fn(model), example_inputs(model, t, h, w, device))
    save_exported(exported, args.output)
    print(f"Exported {cfg.MODEL.META_ARCHITECTURE} inference ({t}x{h}x{w}) to {args.output}")
    return exported


if __name__ == "__main__":
    main(sys.argv[1:])
