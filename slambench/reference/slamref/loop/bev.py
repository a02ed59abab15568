"""Bird's-eye-view projection — ScanContext's descriptor front half (port
of `mr_slam_tpu/loop/bev.py`: `polar_max_height`).

It takes any leading batch of masked fixed-capacity clouds (..., N, 3)
and returns (..., *grid): one scatter over the whole batch, the cell
index offset by the cloud's position in it, a scatter-max
(`scatter_reduce_` "amax", exact in any order).
"""
from __future__ import annotations

import math

import torch

from ..ops.pointcloud import PointCloud


def _flat_batch(pc: PointCloud):
    """(batch shape, xyz (B, N, 3), mask (B, N))."""
    n = pc.xyz.shape[-2]
    return pc.xyz.shape[:-2], pc.xyz.reshape(-1, n, 3), pc.mask.reshape(-1, n)


def _cell_offset(B: int, cells: int, device) -> torch.Tensor:
    return torch.arange(B, device=device)[:, None] * cells


def _scatter_max(flat: torch.Tensor, values: torch.Tensor, n: int, init: float) -> torch.Tensor:
    grid = torch.full((n,), init, dtype=values.dtype, device=values.device)
    return grid.scatter_reduce_(0, flat.reshape(-1), values.reshape(-1), "amax")


def polar_max_height(
    pc: PointCloud,
    n_rings: int = 20,
    n_sectors: int = 60,
    r_max: float = 80.0,
) -> torch.Tensor:
    """ScanContext proper: max point height per (ring, sector) bin
    (`pr_methods/ScanContext.py:13-40`). (..., N, 3) -> (..., n_rings,
    n_sectors); empty bins 0."""
    batch, xyz, mask = _flat_batch(pc)
    B = xyz.shape[0]
    r = torch.sqrt(xyz[..., 0] ** 2 + xyz[..., 1] ** 2)
    theta = torch.atan2(xyz[..., 1], xyz[..., 0])
    m = mask & (r < r_max) & (r > 1e-3)
    ri = torch.clamp((r / r_max * n_rings).to(torch.int64), 0, n_rings - 1)
    si = torch.clamp(
        ((theta + math.pi) / (2 * math.pi) * n_sectors).to(torch.int64), 0, n_sectors - 1
    )
    cells = n_rings * n_sectors
    flat = ri * n_sectors + si + _cell_offset(B, cells, xyz.device)
    z = torch.where(m, xyz[..., 2], -torch.inf)
    grid = _scatter_max(flat, z, B * cells, -torch.inf)
    grid = torch.where(torch.isfinite(grid), grid, 0.0)
    return grid.reshape(*batch, n_rings, n_sectors)
