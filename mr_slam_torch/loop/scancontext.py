"""ScanContext place recognition (port of `mr_slam_tpu/loop/scancontext.py`:
`describe`, `ring_key`, `distance`).

Descriptor = polar max-height matrix (rings x sectors); retrieval key =
per-ring mean; matching = cosine distance minimized over all circular
column shifts, as one batched matmul over queries, shifts and database.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.pointcloud import PointCloud
from . import bev


class SCParams(NamedTuple):
    n_rings: int = 20
    n_sectors: int = 60
    r_max: float = 80.0


def describe(pc: PointCloud, params: SCParams = SCParams()) -> torch.Tensor:
    """(..., n_rings, n_sectors) ScanContext of body-frame keyframe clouds."""
    return bev.polar_max_height(pc, params.n_rings, params.n_sectors, params.r_max)


def ring_key(sc: torch.Tensor) -> torch.Tensor:
    """(..., n_rings) retrieval key: per-ring occupancy mean."""
    return torch.mean(sc, dim=-1)


def distance(query: torch.Tensor, database: torch.Tensor):
    """Min-over-shift cosine distance between queries (..., R, S) and a
    database (D, R, S): dist = 1 - max_s mean_cols cos(q[:, c - s],
    db[:, c]). Returns (dists (..., D), best_shift (..., D))."""
    S = query.shape[-1]
    dev = query.device
    # q_shift[..., s, r, c] = query[..., r, (c - s) mod S]
    idx = (torch.arange(S, device=dev)[None, :] - torch.arange(S, device=dev)[:, None]) % S
    q_shift = query[..., idx].movedim(-3, -2)                 # (..., S, R, C)
    qn = q_shift / torch.clamp(torch.linalg.norm(q_shift, dim=-2, keepdim=True), min=1e-9)
    dn = database / torch.clamp(torch.linalg.norm(database, dim=-2, keepdim=True), min=1e-9)
    lead = qn.shape[:-3]
    R, C = qn.shape[-2:]
    sims = qn.reshape(-1, R * C) @ dn.reshape(-1, R * C).T / S    # (... * S, D)
    sims = sims.reshape(*lead, S, -1).transpose(-1, -2)           # (..., D, S)
    best_sim, best = torch.max(sims, dim=-1)
    return 1.0 - best_sim, best
