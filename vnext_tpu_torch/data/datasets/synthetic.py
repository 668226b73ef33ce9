"""Synthetic YouTube-VIS and COCO datasets for the quick-schedule configs and the tests.

Counterpart of ``vnext_tpu.data.datasets.synthetic``: per-frame PNGs of
coloured rectangles that drift linearly over a noise background, with a
YTVIS-format json (one polygon, box and area per object and frame), and still
PNGs of 1-3 rectangles with a COCO-format json (a polygon, a box, an area and a
17-keypoint grid per object), written under a root the caller gives. The same
seed writes files byte-equal to the JAX package's generator, so the two
packages can be held to each other on the files. Real YouTube-VIS, OVIS and
COCO data are not in the repository.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

# the repository's gitignored build directory: a dataset registered without a root lands there
_DEFAULT_ROOT = Path(__file__).resolve().parents[3] / "build" / "synthetic_datasets"

# the JAX package's format version: a cached dataset of another version is written again
_FORMAT_VERSION = 2

THING_CLASSES = ["square", "wide", "tall"]


def _cache_valid(json_file: str) -> bool:
    if not os.path.exists(json_file):
        return False
    try:
        with open(json_file) as f:
            return json.load(f).get("info", {}).get("synth_format") == _FORMAT_VERSION
    except (OSError, ValueError):
        return False


def _make_image(rng: np.random.RandomState, h: int, w: int, n_objs: int):
    """An [h, w, 3] uint8 noise image with ``n_objs`` filled rectangles, and their
    COCO annotations (the ids are the caller's)."""
    img = (rng.rand(h, w, 3) * 60 + 40).astype(np.uint8)
    annotations = []
    for _ in range(n_objs):
        cls = int(rng.randint(len(THING_CLASSES)))
        if cls == 0:
            bw = bh = int(rng.randint(h // 6, h // 3))
        elif cls == 1:
            bw, bh = int(rng.randint(w // 4, w // 2)), int(rng.randint(h // 8, h // 5))
        else:
            bw, bh = int(rng.randint(w // 8, w // 5)), int(rng.randint(h // 4, h // 2))
        x = int(rng.randint(0, max(w - bw, 1)))
        y = int(rng.randint(0, max(h - bh, 1)))
        color = rng.randint(150, 255, size=3)
        img[y : y + bh, x : x + bw] = color
        # deterministic 17-keypoint grid inside the box (keypoint-RCNN tests)
        kidx = np.arange(17)
        kxs = x + (kidx % 4 + 0.5) / 4.0 * bw
        kys = y + (kidx // 4 + 0.5) / 5.0 * bh
        keypoints = []
        for kx, ky in zip(kxs, kys):
            keypoints += [float(kx), float(ky), 2]
        annotations.append(
            {
                "bbox": [x, y, bw, bh],
                "category_id": cls + 1,
                "segmentation": [
                    [x, y, x + bw, y, x + bw, y + bh, x, y + bh]
                ],
                "area": bw * bh,
                "iscrowd": 0,
                "keypoints": keypoints,
                "num_keypoints": 17,
            }
        )
    return img, annotations


def generate_synthetic_coco(
    root: str, num_images: int = 8, h: int = 160, w: int = 224, seed: int = 0
) -> str:
    """Write PNGs + a COCO json under ``root``; returns the json path."""
    from PIL import Image

    img_dir = os.path.join(root, "images")
    json_file = os.path.join(root, "instances.json")
    if _cache_valid(json_file):
        return json_file
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    images, anns = [], []
    ann_id = 1
    for i in range(num_images):
        img, objs = _make_image(rng, h, w, n_objs=int(rng.randint(1, 4)))
        fname = f"synth_{i:04d}.png"
        _write_atomically(os.path.join(img_dir, fname),
                          lambda tmp: Image.fromarray(img).save(tmp, format="PNG"))
        images.append(
            {"id": i + 1, "file_name": fname, "height": h, "width": w}
        )
        for obj in objs:
            obj = dict(obj, id=ann_id, image_id=i + 1)
            anns.append(obj)
            ann_id += 1
    coco = {
        "info": {"synth_format": _FORMAT_VERSION},
        "images": images,
        "annotations": anns,
        "categories": [
            {"id": i + 1, "name": n} for i, n in enumerate(THING_CLASSES)
        ],
    }
    _write_atomically(json_file, lambda tmp: Path(tmp).write_text(json.dumps(coco)))
    return json_file


def generate_synthetic_ytvis(
    root: str, num_videos: int = 2, num_frames: int = 4,
    h: int = 128, w: int = 192, seed: int = 3,
) -> str:
    """Write per-frame PNGs + a YTVIS-format json; objects drift linearly so
    the tracker has real motion to follow. Returns the json path."""
    from PIL import Image

    json_file = os.path.join(root, "instances.json")
    if _cache_valid(json_file):
        return json_file
    rng = np.random.RandomState(seed)
    videos, anns = [], []
    ann_id = 1
    for v in range(num_videos):
        vdir = os.path.join(root, "JPEGImages", f"video_{v:03d}")
        os.makedirs(vdir, exist_ok=True)
        n_objs = int(rng.randint(1, 3))
        objs = []
        for _ in range(n_objs):
            bw, bh = int(rng.randint(w // 6, w // 3)), int(rng.randint(h // 6, h // 3))
            x, y = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
            dx, dy = int(rng.randint(-4, 5)), int(rng.randint(-4, 5))
            objs.append(dict(
                cls=int(rng.randint(len(THING_CLASSES))), x=x, y=y, bw=bw, bh=bh,
                dx=dx, dy=dy, color=rng.randint(150, 255, size=3),
                segs=[], boxes=[], areas=[],
            ))
        file_names = []
        for f in range(num_frames):
            img = (rng.rand(h, w, 3) * 60 + 40).astype(np.uint8)
            for o in objs:
                x = int(np.clip(o["x"] + f * o["dx"], 0, w - o["bw"]))
                y = int(np.clip(o["y"] + f * o["dy"], 0, h - o["bh"]))
                img[y : y + o["bh"], x : x + o["bw"]] = o["color"]
                o["segs"].append(
                    [[x, y, x + o["bw"], y, x + o["bw"], y + o["bh"], x, y + o["bh"]]]
                )
                o["boxes"].append([x, y, o["bw"], o["bh"]])
                o["areas"].append(o["bw"] * o["bh"])
            fname = f"video_{v:03d}/{f:05d}.png"
            _write_atomically(os.path.join(root, "JPEGImages", fname),
                              lambda tmp: Image.fromarray(img).save(tmp, format="PNG"))
            file_names.append(fname)
        videos.append(
            {"id": v + 1, "height": h, "width": w, "length": num_frames,
             "file_names": file_names}
        )
        for o in objs:
            anns.append(
                {"id": ann_id, "video_id": v + 1, "category_id": o["cls"] + 1,
                 "segmentations": o["segs"], "bboxes": o["boxes"],
                 "areas": o["areas"], "iscrowd": 0, "height": h, "width": w,
                 "length": num_frames}
            )
            ann_id += 1
    ytvis = {
        "info": {"synth_format": _FORMAT_VERSION},
        "videos": videos,
        "annotations": anns,
        "categories": [{"id": i + 1, "name": n} for i, n in enumerate(THING_CLASSES)],
    }
    _write_atomically(json_file, lambda tmp: Path(tmp).write_text(json.dumps(ytvis)))
    return json_file


def _write_atomically(path: str, write) -> None:
    """``write(tmp)`` to a name of this process's, then renamed to ``path``:
    processes that generate one dataset at once never read a half-written file."""
    tmp = f"{path}.tmp{os.getpid()}"
    write(tmp)
    os.replace(tmp, path)


def register_synthetic_ytvis(
    name: str = "ytvis_synthetic_tiny", root: Optional[str] = None, **kwargs
) -> None:
    """Generate (unless a valid copy is there) and register the dataset ``name``
    under ``root`` (default: ``build/synthetic_datasets/<name>`` in the
    repository); ``kwargs`` go to :func:`generate_synthetic_ytvis`. A name
    already registered is left as it is."""
    from ..catalog import DatasetCatalog
    from .ytvis import register_ytvis_instances

    if name in DatasetCatalog:
        return
    root = root or str(_DEFAULT_ROOT / name)
    json_file = generate_synthetic_ytvis(root, **kwargs)
    register_ytvis_instances(
        name,
        {"thing_classes": list(THING_CLASSES)},
        json_file,
        os.path.join(root, "JPEGImages"),
    )


def register_synthetic_coco(
    name: str = "coco_synthetic_tiny",
    root: Optional[str] = None,
    num_images: int = 8,
    h: int = 160,
    w: int = 224,
) -> None:
    """Generate (unless a valid copy is there) and register the COCO-format
    dataset ``name`` under ``root`` (default: ``build/synthetic_datasets/<name>``
    in the repository), with COCO's evaluator type and the 3 classes' id map.
    A name already registered is left as it is."""
    from ..catalog import DatasetCatalog, MetadataCatalog
    from .coco import load_coco_json

    if name in DatasetCatalog:
        return
    root = root or str(_DEFAULT_ROOT / name)
    json_file = generate_synthetic_coco(root, num_images=num_images, h=h, w=w)
    image_root = os.path.join(root, "images")
    DatasetCatalog.register(
        name, lambda: load_coco_json(json_file, image_root, dataset_name=name)
    )
    MetadataCatalog.get(name).set(
        json_file=json_file,
        image_root=image_root,
        evaluator_type="coco",
        thing_classes=list(THING_CLASSES),
        thing_dataset_id_to_contiguous_id={i + 1: i for i in range(len(THING_CLASSES))},
    )
