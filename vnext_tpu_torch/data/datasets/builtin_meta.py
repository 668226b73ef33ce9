"""COCO person-keypoint metadata: names, horizontal-flip pairs and skeleton.

A copy of the part of ``vnext_tpu.data.datasets.builtin_meta`` that COCO's
keypoint splits register (``datasets/coco.py``): the keypoint structure and
connection rules are not in the annotation json, so they live here. Class-name
lists load from the json at registration time.
"""

from __future__ import annotations

# COCO 17-keypoint person layout (builtin_meta.py:134 COCO_PERSON_KEYPOINT_NAMES)
COCO_PERSON_KEYPOINT_NAMES = (
    "nose",
    "left_eye", "right_eye",
    "left_ear", "right_ear",
    "left_shoulder", "right_shoulder",
    "left_elbow", "right_elbow",
    "left_wrist", "right_wrist",
    "left_hip", "right_hip",
    "left_knee", "right_knee",
    "left_ankle", "right_ankle",
)

# pairs swapped by horizontal flip (builtin_meta.py:155 COCO_PERSON_KEYPOINT_FLIP_MAP)
COCO_PERSON_KEYPOINT_FLIP_MAP = (
    ("left_eye", "right_eye"),
    ("left_ear", "right_ear"),
    ("left_shoulder", "right_shoulder"),
    ("left_elbow", "right_elbow"),
    ("left_wrist", "right_wrist"),
    ("left_hip", "right_hip"),
    ("left_knee", "right_knee"),
    ("left_ankle", "right_ankle"),
)

# skeleton edges as keypoint-index pairs (0-based; builtin_meta.py KEYPOINT_CONNECTION_RULES)
COCO_PERSON_SKELETON = (
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12),
    (5, 11), (6, 12), (5, 6), (5, 7), (6, 8), (7, 9),
    (8, 10), (1, 2), (0, 1), (0, 2), (1, 3), (2, 4),
    (3, 5), (4, 6),
)


def keypoint_flip_indices(names=COCO_PERSON_KEYPOINT_NAMES,
                          flip_map=COCO_PERSON_KEYPOINT_FLIP_MAP):
    """Permutation applied to the keypoint axis under a horizontal flip."""
    idx = {n: i for i, n in enumerate(names)}
    perm = list(range(len(names)))
    for a, b in flip_map:
        perm[idx[a]], perm[idx[b]] = idx[b], idx[a]
    return tuple(perm)


def get_keypoint_metadata() -> dict:
    return {
        "keypoint_names": list(COCO_PERSON_KEYPOINT_NAMES),
        "keypoint_flip_map": [list(p) for p in COCO_PERSON_KEYPOINT_FLIP_MAP],
        "keypoint_skeleton": [list(e) for e in COCO_PERSON_SKELETON],
        "keypoint_flip_indices": list(keypoint_flip_indices()),
    }
