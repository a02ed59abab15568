"""Bird's-eye-view projections (port of `mr_slam_tpu/loop/bev.py`; only
`polar_max_height`, the ScanContext front half, so far)."""
from __future__ import annotations

import math

import torch

from ..ops.pointcloud import PointCloud


def polar_max_height(
    pc: PointCloud,
    n_rings: int = 20,
    n_sectors: int = 60,
    r_max: float = 80.0,
) -> torch.Tensor:
    """ScanContext proper: max point height per (ring, sector) bin
    (`pr_methods/ScanContext.py:13-40`). Any leading batch of clouds
    (..., N, 3) -> (..., n_rings, n_sectors). The reference's
    scatter-max becomes `scatter_reduce_(..., "amax")` on a -inf
    initialized grid."""
    xyz = pc.xyz
    batch = xyz.shape[:-2]
    n = xyz.shape[-2]
    xyz = xyz.reshape(-1, n, 3)
    mask = pc.mask.reshape(-1, n)
    B = xyz.shape[0]
    r = torch.sqrt(xyz[..., 0] ** 2 + xyz[..., 1] ** 2)
    theta = torch.atan2(xyz[..., 1], xyz[..., 0])
    m = mask & (r < r_max) & (r > 1e-3)
    ri = torch.clamp((r / r_max * n_rings).to(torch.int64), 0, n_rings - 1)
    si = torch.clamp(
        ((theta + math.pi) / (2 * math.pi) * n_sectors).to(torch.int64), 0, n_sectors - 1
    )
    cells = n_rings * n_sectors
    flat = ri * n_sectors + si + torch.arange(B, device=xyz.device)[:, None] * cells
    z = torch.where(m, xyz[..., 2], -torch.inf)
    grid = torch.full((B * cells,), -torch.inf, device=xyz.device)
    grid.scatter_reduce_(0, flat.reshape(-1), z.reshape(-1), "amax")
    grid = torch.where(torch.isfinite(grid), grid, 0.0)
    return grid.reshape(*batch, n_rings, n_sectors)
