"""Exact min-cost assignment of ground-truth rows to queries, on the host.

Counterpart of ``vnext_tpu.ops.hungarian`` (``hungarian``, ``hungarian_match``).
The JAX package runs a Jonker-Volgenant loop inside jit so that the TPU never
waits on the host; on a GPU the loop's thousands of dependent steps would be
launches, so the port solves on the host with
``scipy.optimize.linear_sum_assignment``, as upstream VNext does. A train step
matches every decoder layer (and every frame) from one cost tensor:
``assign_batched`` copies it to the host once and solves each [K, Q] slice on
its valid rows. The layout is the JAX package's: a query index per row, -1 for
an invalid row.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def _solve(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """cost [K, Q], valid [K] bool (numpy) -> [K] int64 query per row, -1 where invalid."""
    out = np.full(cost.shape[0], -1, np.int64)
    rows = np.flatnonzero(valid)
    if rows.size:
        r, c = linear_sum_assignment(cost[rows])
        out[rows[r]] = c
    return out


def hungarian(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact min-cost assignment of the valid rows of ``cost`` [K, Q] (K <= Q)
    to distinct columns. Returns [K] int64 on ``cost``'s device: the column of
    each valid row, -1 for an invalid one."""
    return assign_batched(cost[None], valid[None])[0]


def assign_batched(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``hungarian`` over the leading dimensions of ``cost`` [..., K, Q] and
    ``valid`` [..., K], with one copy of each to the host."""
    lead, (k, q) = cost.shape[:-2], cost.shape[-2:]
    c = cost.detach().float().reshape(-1, k, q).cpu().numpy()
    v = valid.detach().reshape(-1, k).cpu().numpy().astype(bool)
    out = np.stack([_solve(ci, vi) for ci, vi in zip(c, v)]) if len(c) else np.zeros((0, k), np.int64)
    return torch.from_numpy(out).reshape(*lead, k).to(cost.device)


def hungarian_match(cost: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(query for each row [K], selected query [Q] bool, row of each query [Q]
    int, 0 where unselected), as the JAX package's ``hungarian_match``."""
    k, q = cost.shape
    assignment = hungarian(cost, valid)
    idx = torch.where(assignment >= 0, assignment, q)                 # unassigned rows scatter past the end
    sel = torch.zeros(q + 1, dtype=torch.bool, device=cost.device).index_fill_(0, idx, True)[:q]
    gt_for_query = torch.zeros(q + 1, dtype=torch.int64, device=cost.device).scatter_(
        0, idx, torch.arange(k, device=cost.device))[:q]
    return assignment, sel, gt_for_query
