"""Synthetic YouTube-VIS and COCO datasets for the quick-schedule configs and the tests.

Counterpart of ``vnext_tpu.data.datasets.synthetic``: per-frame PNGs of
coloured rectangles that drift linearly over a noise background, with a
YTVIS-format json (one polygon, box and area per object and frame), and still
PNGs of 1-3 rectangles with a COCO-format json (a polygon, a box, an area and a
17-keypoint grid per object), written under a root the caller gives. The same
seed writes files byte-equal to the JAX package's generator, so the two
packages can be held to each other on the files. Real YouTube-VIS, OVIS and
COCO data are not in the repository.

``generate_synthetic_panoptic`` (test data for PanopticFPN and
SemanticSegmentor; the JAX package has none) writes the COCO set's images and
instances (byte-equal for the same seed) and labels them with two stuff bands
and a void strip drawn apart, in detectron2's "separated" files: the
instances json, a stuff label PNG per image (things 0, void 255) and a
COCO-panoptic id PNG (``id2rgb``) with its json.

``generate_synthetic_lvis``, ``generate_synthetic_voc`` and
``generate_synthetic_cityscapes`` (the JAX package has none) write each of
those datasets in its own on-disk layout under a root, so that the builtin
splits (``datasets/builtin.py``) find them there as they would the real
data: LVIS v1 / v0.5 jsons with every category, VOC2007 / VOC2012 XML
annotations and split lists, Cityscapes' leftImg8bit images with their
gtFine instance-id and train-id PNGs.
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


# the panoptic set's format version (a cached copy of another is written again)
_PANOPTIC_FORMAT = 2


def _panoptic_maps(rng: np.random.RandomState, h: int, w: int, annotations, sem_seg_classes: int):
    """The stuff label map [h, w] (two bands of semantic classes 1.., drawn
    from ``rng``, things 0, a void strip of 255 along the bottom), the
    panoptic id map [h, w] (0 = void) and its segments' info, for rectangles
    ``annotations`` painted in order over the bands (a later one covers an
    earlier one, as in the image). Segment category ids are those the
    panoptic fusion writes: a thing's contiguous class (its dataset id - 1), a
    stuff band's semantic class."""
    cut = int(rng.randint(h // 4, 3 * h // 4))
    bands = rng.randint(1, sem_seg_classes, size=2)
    sem = np.empty((h, w), np.int32)
    sem[:cut], sem[cut:] = bands
    owner = np.full((h, w), -1, np.int64)
    for i, ann in enumerate(annotations):
        x, y, bw, bh = ann["bbox"]
        owner[y:y + bh, x:x + bw] = i
    sem[owner >= 0] = 0
    sem[h - max(h // 40, 1):] = 255
    pan = np.zeros((h, w), np.int32)
    segments = []

    def add(mask, category_id, isthing):
        if not mask.any():
            return
        ys, xs = np.nonzero(mask)
        seg_id = len(segments) + 1
        pan[mask] = seg_id
        segments.append({"id": seg_id, "category_id": int(category_id), "iscrowd": 0, "isthing": isthing,
                         "area": int(mask.sum()), "bbox": [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                                                          int(ys.max() - ys.min() + 1)]})

    for cls in np.unique(bands):
        add(sem == cls, cls, False)
    for i, ann in enumerate(annotations):
        add((owner == i) & (sem != 255), ann["category_id"] - 1, True)
    return sem, pan, segments


def generate_synthetic_panoptic(root: str, num_images: int = 8, h: int = 160, w: int = 224, seed: int = 0,
                                sem_seg_classes: int = 4, thing_classes=THING_CLASSES) -> dict:
    """Write under ``root`` the images (``images/``) and ``instances.json`` of
    ``generate_synthetic_coco`` for the same seed (the same draws: byte-equal
    PNGs, the same objects; categories ``thing_classes``, the objects taking
    ids 1-3), ``sem_seg/`` (stuff label PNGs of ``sem_seg_classes`` classes,
    their bands drawn from a generator of their own: the stuff is labelled,
    not painted), and ``panoptic/`` with ``panoptic.json`` (one annotation per
    image: its id PNG's file name and its segments' info). Returns the paths
    by key (image_root, instances_json, sem_seg_root, panoptic_root,
    panoptic_json)."""
    from PIL import Image

    from .coco_panoptic import id2rgb

    paths = {"image_root": os.path.join(root, "images"), "instances_json": os.path.join(root, "instances.json"),
             "sem_seg_root": os.path.join(root, "sem_seg"), "panoptic_root": os.path.join(root, "panoptic"),
             "panoptic_json": os.path.join(root, "panoptic.json")}
    if os.path.exists(paths["panoptic_json"]):
        with open(paths["panoptic_json"]) as f:
            if json.load(f).get("info", {}).get("synth_panoptic_format") == _PANOPTIC_FORMAT:
                return paths
    for key in ("image_root", "sem_seg_root", "panoptic_root"):
        os.makedirs(paths[key], exist_ok=True)
    rng, stuff_rng = np.random.RandomState(seed), np.random.RandomState(seed + 1)
    images, anns, pan_anns = [], [], []
    for i in range(num_images):
        img, objs = _make_image(rng, h, w, n_objs=int(rng.randint(1, 4)))
        sem, pan, segments = _panoptic_maps(stuff_rng, h, w, objs, sem_seg_classes)
        fname = f"synth_{i:04d}.png"
        for folder, array in (("image_root", img), ("sem_seg_root", sem.astype(np.uint8)),
                              ("panoptic_root", id2rgb(pan))):
            _write_atomically(os.path.join(paths[folder], fname),
                              lambda tmp, a=array: Image.fromarray(a).save(tmp, format="PNG"))
        images.append({"id": i + 1, "file_name": fname, "height": h, "width": w})
        anns += [dict(obj, id=len(anns) + k + 1, image_id=i + 1) for k, obj in enumerate(objs)]
        pan_anns.append({"image_id": i + 1, "file_name": fname, "segments_info": segments})
    categories = [{"id": i + 1, "name": n} for i, n in enumerate(thing_classes)]
    coco = {"info": {"synth_format": _FORMAT_VERSION}, "images": images, "annotations": anns,
            "categories": categories}
    _write_atomically(paths["instances_json"], lambda tmp: Path(tmp).write_text(json.dumps(coco)))
    panoptic = {"info": {"synth_panoptic_format": _PANOPTIC_FORMAT}, "images": images, "annotations": pan_anns}
    _write_atomically(paths["panoptic_json"], lambda tmp: Path(tmp).write_text(json.dumps(panoptic)))
    return paths


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


def register_synthetic_panoptic(name: str = "coco_panoptic_synthetic_tiny", root: Optional[str] = None,
                                num_images: int = 8, h: int = 160, w: int = 224, sem_seg_classes: int = 4,
                                thing_classes=THING_CLASSES, seed: int = 0) -> None:
    """Generate (unless a valid copy is there) the panoptic set under ``root``
    (default: ``build/synthetic_datasets/<name>`` in the repository) and
    register it twice over the same files: ``name`` through
    ``register_coco_panoptic`` ("separated" records, the ``coco_panoptic_seg``
    evaluator type) and ``name + "_sem_seg"`` with the ``sem_seg`` type, both
    with the thing classes' id map and the ``sem_seg_classes`` stuff classes
    ("things" first). A name already registered is left as it is."""
    from ..catalog import DatasetCatalog, MetadataCatalog
    from .coco_panoptic import register_coco_panoptic

    if name in DatasetCatalog:
        return
    root = root or str(_DEFAULT_ROOT / name)
    paths = generate_synthetic_panoptic(root, num_images, h, w, seed, sem_seg_classes, thing_classes)
    metadata = dict(thing_classes=list(thing_classes),
                    thing_dataset_id_to_contiguous_id={i + 1: i for i in range(len(thing_classes))},
                    stuff_classes=["things"] + [f"stuff_{i}" for i in range(1, sem_seg_classes)], ignore_label=255)
    register_coco_panoptic(name, metadata, paths["image_root"], paths["panoptic_root"], paths["panoptic_json"],
                           instances_json=paths["instances_json"], sem_seg_root=paths["sem_seg_root"])
    twin = f"{name}_sem_seg"
    DatasetCatalog.register(twin, lambda: DatasetCatalog.get(name))
    MetadataCatalog.get(twin).set(evaluator_type="sem_seg", json_file=paths["instances_json"], **metadata)


# LVIS's categories by frequency band (rare, common, frequent), as its published jsons count them
LVIS_FREQUENCY_COUNTS = {"v1": (337, 461, 405), "v0.5": (454, 461, 315)}


def _rectangles(rng: np.random.RandomState, h: int, w: int, n_objs: int):
    """An [h, w, 3] uint8 noise image with ``n_objs`` filled rectangles drawn
    in order, and their (x, y, bw, bh) boxes."""
    img = (rng.rand(h, w, 3) * 60 + 40).astype(np.uint8)
    boxes = []
    for _ in range(n_objs):
        bw, bh = int(rng.randint(w // 8, w // 3)), int(rng.randint(h // 8, h // 3))
        x, y = int(rng.randint(0, w - bw)), int(rng.randint(0, h - bh))
        img[y:y + bh, x:x + bw] = rng.randint(150, 255, size=3)
        boxes.append((x, y, bw, bh))
    return img, boxes


def _save(path: str, array: np.ndarray, **kwargs) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    fmt = "JPEG" if path.endswith(".jpg") else "PNG"
    _write_atomically(path, lambda tmp: Image.fromarray(array).save(tmp, format=fmt, **kwargs))


def generate_synthetic_lvis(root: str, num_train: int = 2, num_val: int = 4, h: int = 480, w: int = 640,
                            seed: int = 0) -> dict:
    """LVIS under ``root``: JPEGs under ``coco/train2017`` and ``coco/val2017``
    (named by each image's ``coco_url``, as LVIS names them), shared by
    ``lvis/lvis_v1_{train,val}.json`` and ``lvis/lvis_v0.5_{train,val}.json``.
    Each json lists all of its version's categories (1203 or 1230, ids from
    1, with synonyms and r / c / f frequencies in LVIS's counts); each object
    is a rectangle of a category drawn from the three bands in turn, with a
    polygon, an XYWH box and an area; each image has ``neg_category_ids``
    (categories it does not show) and ``not_exhaustive_category_ids`` (one
    it shows). Returns the json paths by name (``lvis_v1_val``, ...)."""
    rng = np.random.RandomState(seed)
    images = {}
    for split, n in (("train", num_train), ("val", num_val)):
        images[split] = []
        for i in range(n):
            img, boxes = _rectangles(rng, h, w, int(rng.randint(1, 4)))
            image_id = len(images["train"]) + i + 1 if split == "val" else i + 1
            fname = f"{image_id:012d}.jpg"
            _save(os.path.join(root, "coco", f"{split}2017", fname), img, quality=95)
            images[split].append((image_id, fname, boxes))
    paths = {}
    for version, counts in LVIS_FREQUENCY_COUNTS.items():
        bands = [[] for _ in counts]
        categories = []
        for freq, (band, n) in enumerate(zip("rcf", counts)):
            for _ in range(n):
                cat_id = len(categories) + 1
                bands[freq].append(cat_id)
                categories.append({"id": cat_id, "name": f"lvis_{version}_{cat_id:04d}",
                                   "synonyms": [f"lvis_{version}_{cat_id:04d}"], "frequency": band,
                                   "image_count": int(rng.randint(1, 10)), "instance_count": int(rng.randint(1, 20))})
        for split, entries in images.items():
            imgs, anns = [], []
            for image_id, fname, boxes in entries:
                shown = []
                for k, (x, y, bw, bh) in enumerate(boxes):
                    band = bands[(image_id + k) % 3]
                    cat_id = int(band[rng.randint(len(band))])
                    shown.append(cat_id)
                    anns.append({"id": len(anns) + 1, "image_id": image_id, "category_id": cat_id,
                                 "bbox": [x, y, bw, bh], "area": bw * bh,
                                 "segmentation": [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]})
                absent = [c for c in rng.choice(len(categories), 3, replace=False) + 1 if c not in shown]
                imgs.append({"id": image_id, "height": h, "width": w,
                             "coco_url": f"http://images.cocodataset.org/{split}2017/{fname}",
                             "neg_category_ids": [int(c) for c in absent],
                             "not_exhaustive_category_ids": shown[:1]})
            path = os.path.join(root, "lvis", f"lvis_{version}_{split}.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            data = {"info": {"synthetic": True}, "images": imgs, "annotations": anns, "categories": categories}
            _write_atomically(path, lambda tmp, d=data: Path(tmp).write_text(json.dumps(d)))
            paths[f"lvis_{version}_{split}"] = path
    return paths


def _voc_xml(fileid: str, h: int, w: int, objects) -> str:
    """A VOC annotation: (class name, difficult, xmin, ymin, xmax, ymax) per
    object in VOC's 1-based inclusive pixels."""
    objs = "".join(
        f"<object><name>{name}</name><pose>Unspecified</pose><truncated>0</truncated>"
        f"<difficult>{int(difficult)}</difficult><bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin>"
        f"<xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>"
        for name, difficult, x0, y0, x1, y1 in objects)
    return (f"<annotation><folder>VOC</folder><filename>{fileid}.jpg</filename><size><width>{w}</width>"
            f"<height>{h}</height><depth>3</depth></size><segmented>0</segmented>{objs}</annotation>")


def generate_synthetic_voc(root: str, num_train: int = 1, num_val: int = 1, num_test: int = 4, h: int = 375,
                           w: int = 500, seed: int = 0) -> None:
    """``VOC2007/`` and ``VOC2012/`` under ``root``, each with
    ``Annotations/<id>.xml``, ``JPEGImages/<id>.jpg`` and
    ``ImageSets/Main/{train,val,trainval}.txt`` (VOC2007 also ``test.txt``):
    1-3 rectangles an image, each of one of the 20 classes, every third
    object ``difficult``."""
    from .pascal_voc import CLASS_NAMES

    rng = np.random.RandomState(seed)
    for year, splits in ((2007, (("train", num_train), ("val", num_val), ("test", num_test))),
                         (2012, (("train", num_train), ("val", num_val)))):
        base = os.path.join(root, f"VOC{year}")
        os.makedirs(os.path.join(base, "Annotations"), exist_ok=True)
        os.makedirs(os.path.join(base, "ImageSets", "Main"), exist_ok=True)
        lists, count = {}, 0
        for split, n in splits:
            lists[split] = []
            for _ in range(n):
                count += 1
                fileid = f"{count:06d}" if year == 2007 else f"{year}_{count:06d}"
                img, boxes = _rectangles(rng, h, w, int(rng.randint(1, 4)))
                _save(os.path.join(base, "JPEGImages", fileid + ".jpg"), img, quality=95)
                objects = [(CLASS_NAMES[rng.randint(len(CLASS_NAMES))], k % 3 == 2, x + 1, y + 1, x + bw, y + bh)
                           for k, (x, y, bw, bh) in enumerate(boxes)]
                Path(base, "Annotations", fileid + ".xml").write_text(_voc_xml(fileid, h, w, objects))
                lists[split].append(fileid)
        lists["trainval"] = lists["train"] + lists["val"]
        for split, ids in lists.items():
            Path(base, "ImageSets", "Main", split + ".txt").write_text("".join(f"{i}\n" for i in ids))


# Cityscapes label ids: the stuff drawn under the things (road, building, sky) and their train ids
_CITYSCAPES_STUFF = ((7, 0), (11, 2), (23, 10))
_CITYSCAPES_THING_TRAIN_IDS = {24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18}


def generate_synthetic_cityscapes(root: str, num_train: int = 1, num_val: int = 4, h: int = 1024, w: int = 2048,
                                  seed: int = 0) -> None:
    """``cityscapes/`` under ``root``: ``leftImg8bit/{train,val}/<city>/
    <city>_<seq>_<frame>_leftImg8bit.png`` with, under ``gtFine/`` at the same
    place, ``..._gtFine_instanceIds.png`` (16-bit: sky, building and road
    bands as their label ids, each thing rectangle as label id * 1000 + its
    index, an unlabeled strip 0) and ``..._gtFine_labelTrainIds.png`` (uint8:
    train ids, 255 void)."""
    from .cityscapes import CITYSCAPES_THING_CLASSES

    rng = np.random.RandomState(seed)
    for split, city, n in (("train", "aachen", num_train), ("val", "frankfurt", num_val)):
        for i in range(n):
            base = f"{city}_{i:06d}_000019"
            img, boxes = _rectangles(rng, h, w, int(rng.randint(2, 5)))
            inst = np.zeros((h, w), np.uint16)
            train_ids = np.full((h, w), 255, np.uint8)
            cuts = (0, h // 4, h // 2, h - max(h // 32, 1))
            for (label_id, train_id), top, bottom in zip(_CITYSCAPES_STUFF[::-1], cuts[:-1], cuts[1:]):
                inst[top:bottom], train_ids[top:bottom] = label_id, train_id
            for k, (x, y, bw, bh) in enumerate(boxes):
                label_id = CITYSCAPES_THING_CLASSES[rng.randint(len(CITYSCAPES_THING_CLASSES))][1]
                inst[y:y + bh, x:x + bw] = label_id * 1000 + k
                train_ids[y:y + bh, x:x + bw] = _CITYSCAPES_THING_TRAIN_IDS[label_id]
            inst[cuts[-1]:], train_ids[cuts[-1]:] = 0, 255
            _save(os.path.join(root, "cityscapes", "leftImg8bit", split, city, base + "_leftImg8bit.png"), img,
                  compress_level=1)
            gt = os.path.join(root, "cityscapes", "gtFine", split, city, base)
            _save(gt + "_gtFine_instanceIds.png", inst)
            _save(gt + "_gtFine_labelTrainIds.png", train_ids)
