"""Versioned config back-compat (capability parity with
detectron2/config/compat.py: upgrade_config/downgrade_config walk rename tables
between CfgNode VERSIONs so old yaml files keep loading).

Version history here starts at 1 (pre-TPU key layout) -> 2 (current defaults):
v1 used MODEL.TPU_* flat keys; v2 nests them under the TPU section.

The port's copy of ``vnext_tpu.config.compat`` on its own ``CfgNode``.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

from .cfgnode import CfgNode

logger = logging.getLogger("vnext_tpu_torch")

# (old dotted key, new dotted key) per version step v -> v+1
_RENAMES: dict[int, List[Tuple[str, str]]] = {
    1: [
        ("MODEL.TPU_MESH_SHAPE", "TPU.MESH_SHAPE"),
        ("MODEL.TPU_COMPUTE_DTYPE", "TPU.COMPUTE_DTYPE"),
    ],
}
LATEST_VERSION = 2


def _get(cfg: CfgNode, dotted: str):
    node = cfg
    for k in dotted.split("."):
        if k not in node:
            return None
        node = node[k]
    return node


def _set(cfg: CfgNode, dotted: str, value) -> None:
    parts = dotted.split(".")
    node = cfg
    for k in parts[:-1]:
        if k not in node:
            node[k] = CfgNode()
        node = node[k]
    node[parts[-1]] = value


def _del(cfg: CfgNode, dotted: str) -> None:
    parts = dotted.split(".")
    node = cfg
    for k in parts[:-1]:
        node = node[k]
    del node[parts[-1]]
    # prune empty parents
    if len(parts) > 1:
        parent = cfg
        for k in parts[:-2]:
            parent = parent[k]
        if not node:
            del parent[parts[-2]]


def upgrade_config(cfg: CfgNode, to_version: int = LATEST_VERSION) -> CfgNode:
    """Return a copy of cfg upgraded from cfg.VERSION to to_version."""
    cfg = cfg.clone()
    version = cfg.get("VERSION", 1)
    if version > to_version:
        raise ValueError(f"cannot upgrade from {version} down to {to_version}")
    for v in range(version, to_version):
        for old, new in _RENAMES.get(v, []):
            val = _get(cfg, old)
            if val is not None:
                _set(cfg, new, val)
                _del(cfg, old)
                logger.info("config upgrade v%d->v%d: %s -> %s", v, v + 1, old, new)
        cfg.VERSION = v + 1
    return cfg


def downgrade_config(cfg: CfgNode, to_version: int) -> CfgNode:
    """Inverse of upgrade_config (best effort, for writing old-format yamls)."""
    cfg = cfg.clone()
    version = cfg.get("VERSION", LATEST_VERSION)
    if version < to_version:
        raise ValueError(f"cannot downgrade from {version} up to {to_version}")
    for v in range(version, to_version, -1):
        for old, new in _RENAMES.get(v - 1, []):
            val = _get(cfg, new)
            if val is not None:
                _set(cfg, old, val)
                _del(cfg, new)
        cfg.VERSION = v - 1
    return cfg
