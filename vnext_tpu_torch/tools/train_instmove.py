"""InstMove motion-predictor training entry point, on one NVIDIA GPU.

Counterpart of ``tools/train_instmove.py`` (the JAX package's):

    python -m vnext_tpu_torch.tools.train_instmove --config-file configs/minvis/ovis_r50_motion.yaml \\
        DATASETS.TRAIN "('ytvis_synthetic_tiny',)" OUTPUT_DIR out [MODEL.DEVICE cpu]

Every run of ``MODEL.INSTMOVE.SEQ_LEN`` + 1 consecutive annotated frames of a
track in each ``DATASETS.TRAIN`` dataset (YTVIS format) becomes one sample: the
masks cropped around the run's union box (a square of twice the larger extent,
at least 32 pixels, clipped to the frame) and resized to
``MODEL.INSTMOVE.MASK_SIZE``, and the target frame's image cropped and resized
the same way. Batches of ``SOLVER.IMS_PER_BATCH`` samples are drawn with
``np.random.RandomState(max(SEED, 0)).randint``, as the JAX tool draws them, so
the same config gives the same batches. The phase-2 predictor (f32, as the JAX
tool builds it) is fit with ``instmove_loss`` (BCE + dice on the next mask).

The optimizer is the JAX tool's ``optax.adamw(BASE_LR, weight_decay=WEIGHT_DECAY)``
over every parameter, with no schedule, no clip and no frozen mask: unlike every
other recipe it also updates the image ResNet-50's stem and FrozenBN weights,
biases and running statistics. The port reproduces that on purpose
(``torch.optim.AdamW`` at optax's betas and eps) and does not use
``solver/build.py``'s recipe. Checkpoints (the model's state dict, which
``MODEL.INSTMOVE.WEIGHTS`` loads) are written every ``SOLVER.CHECKPOINT_PERIOD``
steps as ``instmove_<step>.pth`` and at the end as ``instmove_final.pth``.

The JAX tool takes ``--resume`` and ignores it; the port refuses it. The run is
on the card unless the config says ``MODEL.DEVICE cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from collections import defaultdict

import numpy as np
import torch

from ..checkpoint.checkpointer import Checkpointer
from ..config import add_maskformer_config
from ..data.catalog import DatasetCatalog
from ..evaluation.rle import rle_decode
from ..models.instmove import build_instmove_model, instmove_loss
from ..structures.masks import polygons_to_bitmask
from ..utils.events import CommonMetricPrinter, EventStorage, JSONWriter
from .train_net import _register_datasets, resolve_device, setup

logger = logging.getLogger("vnext_tpu_torch")

# optax.adamw's defaults, which the JAX tool keeps
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def default_argument_parser():
    parser = argparse.ArgumentParser(description="InstMove predictor training")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true",
                        help="refused: the JAX tool takes the flag and ignores it (ROADMAP Queue 3)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def _rasterize(anno, h, w):
    segm = anno.get("segmentation")
    if segm is None:
        return None
    if isinstance(segm, dict):
        return rle_decode(segm)
    return polygons_to_bitmask([np.asarray(p) for p in segm], h, w)


def _crop_resize(mask, box, out_hw):
    from PIL import Image

    x0, y0, x1, y1 = [int(v) for v in box]
    patch = mask[y0:y1, x0:x1].astype(np.uint8) * 255
    img = Image.fromarray(patch).resize((out_hw[1], out_hw[0]), Image.BILINEAR)
    return (np.asarray(img) > 127).astype(np.float32)


def build_mask_sequences(dataset_name: str, seq_len: int, mask_hw, limit=None):
    """[(past [T, h, w], target [h, w], image file or None, crop box)] of every
    run of ``seq_len`` + 1 consecutive frames in which a track has a non-empty
    mask, in the JAX tool's order."""
    samples = []
    for rec in DatasetCatalog.get(dataset_name):
        h, w = rec["height"], rec["width"]
        tracks = defaultdict(dict)
        for fi, frame_annos in enumerate(rec["annotations"] or []):
            for a in frame_annos or []:
                tracks[a["id"]][fi] = a
        for frames in tracks.values():
            for start in range(rec["length"] - seq_len):
                window = [frames.get(start + i) for i in range(seq_len + 1)]
                if any(x is None for x in window):
                    continue
                masks = [_rasterize(a, h, w) for a in window]
                if any(m is None or not m.any() for m in masks):
                    continue
                union = np.stack(masks).any(0)
                ys, xs = np.nonzero(union)
                cy, cx = (ys.min() + ys.max()) / 2, (xs.min() + xs.max()) / 2
                half = max(ys.max() - ys.min(), xs.max() - xs.min(), 16)
                box = [max(int(cx - half), 0), max(int(cy - half), 0),
                       min(int(cx + half), w), min(int(cy + half), h)]
                crops = [_crop_resize(m, box, mask_hw) for m in masks]
                fname = None
                files = rec.get("file_names")
                if files and start + seq_len < len(files):
                    fname = files[start + seq_len]
                samples.append((np.stack(crops[:-1]), crops[-1], fname, box))
                if limit and len(samples) >= limit:
                    return samples
    return samples


def _load_image(fname, box, out_hw):
    """The target frame's crop, resized; a missing file gives a zero image, as
    the JAX tool's data rule has it."""
    from PIL import Image

    if fname and os.path.exists(fname):
        img = Image.open(fname).convert("RGB")
        img = img.crop(box).resize((out_hw[1], out_hw[0]), Image.BILINEAR)
        return np.asarray(img, np.float32)
    return np.zeros((*out_hw, 3), np.float32)


def make_batch(samples, rng: np.random.RandomState, batch_size: int, mask_hw, mean, std):
    """One batch as the JAX tool draws it: (past [B, T, h, w, 1], next [B, 1, h, w, 1],
    normalized images [B, h, w, 3]), numpy f32."""
    idx = rng.randint(0, len(samples), batch_size)
    past = np.stack([samples[i][0] for i in idx])[..., None]
    nxt = np.stack([samples[i][1] for i in idx])[:, None, ..., None]
    imgs = np.stack([(_load_image(samples[i][2], samples[i][3], mask_hw) - mean) / std for i in idx])
    return past, nxt, imgs.astype(np.float32)


def build_instmove_optimizer(cfg, model) -> torch.optim.AdamW:
    """The JAX tool's ``optax.adamw``: every parameter, the frozen ones too."""
    return torch.optim.AdamW(model.parameters(), lr=cfg.SOLVER.BASE_LR, betas=ADAM_BETAS, eps=ADAM_EPS,
                             weight_decay=cfg.SOLVER.WEIGHT_DECAY)


def make_instmove_step(model, optimizer):
    """``step(past, nxt, imgs) -> (total, losses)``: the predictor's forward
    (one predicted step), ``instmove_loss``, the backward and the AdamW update;
    the losses are detached and still on the device. A parameter the loss does
    not reach (the image ResNet's res4 and res5 stages, which hold parameters,
    as the flax tree does, but do not run) keeps a zero gradient rather than
    none, so that AdamW decays it as optax does."""
    for p in model.parameters():
        p.grad = torch.zeros_like(p)

    def step(past, nxt, imgs):
        losses = instmove_loss(model(past, imgs, out_len=1), nxt)
        total = losses["loss_mask"] + losses["loss_dice"]
        optimizer.zero_grad(set_to_none=False)
        total.backward()
        optimizer.step()
        return total.detach(), {k: v.detach() for k, v in losses.items()}

    return step


def do_train(cfg, resume: bool = False):
    """Train the predictor for ``SOLVER.MAX_ITER`` steps; returns (model, the
    event storage)."""
    if resume:
        raise ValueError("train_instmove --resume: the JAX tool takes the flag and ignores it (every run starts "
                         "at step 0 from fresh weights); the port refuses it rather than seem to resume "
                         "(ROADMAP Queue 3)")
    _register_datasets(cfg)
    device = resolve_device(cfg)
    seq_len = cfg.MODEL.INSTMOVE.SEQ_LEN
    mask_hw = tuple(cfg.MODEL.INSTMOVE.MASK_SIZE)
    samples = []
    for name in cfg.DATASETS.TRAIN:
        samples += build_mask_sequences(name, seq_len, mask_hw)
    if not samples:
        raise RuntimeError("no mask sequences found in the training datasets")
    logger.info("InstMove: %d mask sequences", len(samples))

    model = build_instmove_model(cfg, device=device, seed=0).train()
    optimizer = build_instmove_optimizer(cfg, model)
    step = make_instmove_step(model, optimizer)
    b = max(1, cfg.SOLVER.IMS_PER_BATCH)
    mean, std = np.asarray(cfg.MODEL.PIXEL_MEAN), np.asarray(cfg.MODEL.PIXEL_STD)
    rng = np.random.RandomState(max(cfg.SEED, 0))
    rng.randint(0, len(samples), b)          # the JAX tool's init batch, drawn before the loop
    checkpointer = Checkpointer(cfg.OUTPUT_DIR)

    writers = [CommonMetricPrinter(cfg.SOLVER.MAX_ITER), JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json"))]
    with EventStorage(0) as storage:
        for it in range(cfg.SOLVER.MAX_ITER):
            storage.iter = it
            batch = make_batch(samples, rng, b, mask_hw, mean, std)
            past, nxt, imgs = (torch.from_numpy(a).to(device) for a in batch)
            total, losses = step(past, nxt, imgs)
            storage.put_scalar("total_loss", float(total))
            for k, v in losses.items():
                storage.put_scalar(k, float(v))
            if (it + 1) % 20 == 0 or it + 1 == cfg.SOLVER.MAX_ITER:
                for writer in writers:
                    writer.write()
            if (it + 1) % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
                checkpointer.save(f"instmove_{it + 1:07d}", {"model": model.state_dict()})
    for writer in writers:
        writer.close()
    checkpointer.save("instmove_final", {"model": model.state_dict()})
    return model, storage


def main(argv=None):
    """Parse ``argv`` (default ``sys.argv[1:]``) and train; returns ``do_train``'s
    (model, storage)."""
    args = default_argument_parser().parse_args(argv)
    return do_train(setup(args, add_maskformer_config), resume=args.resume)


if __name__ == "__main__":
    main(sys.argv[1:])
