"""Bird's-eye-view projections — the descriptor front half (port of
`mr_slam_tpu/loop/bev.py`: `normalize_cloud`, `cartesian_occupancy`,
`polar_occupancy`, `polar_max_height`, `eigen_feature_bev`).

Every function takes any leading batch of masked fixed-capacity clouds
(..., N, 3) and returns (..., *grid): one scatter over the whole batch,
the cell index offset by the cloud's position in it. The occupancy and
max-height grids are scatter-maxes (`scatter_reduce_` "amax", exact in
any order); the eigen-feature BEV's mean is a scatter-add through
`ops/segment.py`, which adds in point order on every device.
"""
from __future__ import annotations

import math

import torch

from ..ops import linalg3, segment
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


def normalize_cloud(pc: PointCloud, xy_max: float = 70.0, z_min: float = 0.0,
                    z_max: float = 30.0) -> PointCloud:
    """Crop to the RING working volume and scale into [-1, 1]^2 x [0, 1]
    (`RING_ros/util.py:91-112` load_pc_infer)."""
    xyz = pc.xyz
    m = (
        pc.mask
        & (torch.abs(xyz[..., 0]) < xy_max)
        & (torch.abs(xyz[..., 1]) < xy_max)
        & (xyz[..., 2] > z_min)
        & (xyz[..., 2] < z_max)
    )
    scaled = torch.stack(
        [xyz[..., 0] / xy_max, xyz[..., 1] / xy_max, (xyz[..., 2] - z_min) / (z_max - z_min)],
        dim=-1,
    )
    return PointCloud(torch.where(m[..., None], scaled, 2.0), m)


def cartesian_occupancy(pc_norm: PointCloud, h: int = 120, w: int = 120, z_bins: int = 1):
    """Occupancy BEV from normalized clouds: a cell is 1 if any point
    falls in it (z_bins > 1 gives a stacked height-sliced BEV). Returns
    (..., z_bins, h, w) float32 in {0, 1}."""
    batch, xyz, mask = _flat_batch(pc_norm)
    B = xyz.shape[0]
    i = torch.clamp(((xyz[..., 1] + 1.0) * 0.5 * h).to(torch.int64), 0, h - 1)
    j = torch.clamp(((xyz[..., 0] + 1.0) * 0.5 * w).to(torch.int64), 0, w - 1)
    k = torch.clamp((xyz[..., 2] * z_bins).to(torch.int64), 0, z_bins - 1)
    cells = z_bins * h * w
    flat = (k * h + i) * w + j + _cell_offset(B, cells, xyz.device)
    grid = _scatter_max(flat, mask.to(torch.float32), B * cells, 0.0)
    return grid.reshape(*batch, z_bins, h, w)


def polar_occupancy(
    pc: PointCloud,
    n_rings: int = 40,
    n_sectors: int = 120,
    z_bins: int = 1,
    r_max: float = 70.0,
    z_min: float = 0.0,
    z_max: float = 30.0,
):
    """Polar (ring, sector, height) occupancy from METRIC clouds —
    DiSCO's `point2gridmap` and the ScanContext polar partition. Returns
    (..., z_bins, n_rings, n_sectors)."""
    batch, xyz, mask = _flat_batch(pc)
    B = xyz.shape[0]
    r = torch.sqrt(xyz[..., 0] ** 2 + xyz[..., 1] ** 2)
    theta = torch.atan2(xyz[..., 1], xyz[..., 0])
    m = mask & (r < r_max) & (xyz[..., 2] > z_min) & (xyz[..., 2] < z_max) & (r > 1e-3)
    ri = torch.clamp((r / r_max * n_rings).to(torch.int64), 0, n_rings - 1)
    si = torch.clamp(((theta + math.pi) / (2 * math.pi) * n_sectors).to(torch.int64), 0,
                     n_sectors - 1)
    zi = torch.clamp(((xyz[..., 2] - z_min) / (z_max - z_min) * z_bins).to(torch.int64), 0,
                     z_bins - 1)
    cells = z_bins * n_rings * n_sectors
    flat = (zi * n_rings + ri) * n_sectors + si + _cell_offset(B, cells, xyz.device)
    grid = _scatter_max(flat, m.to(torch.float32), B * cells, 0.0)
    return grid.reshape(*batch, z_bins, n_rings, n_sectors)


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


def eigen_feature_bev(pc: PointCloud, h: int = 120, w: int = 120, k: int = 16,
                      xy_max: float = 70.0):
    """RING++ multi-channel feature BEV: per-point neighbourhood eigen
    statistics averaged into 6 channels per cell (linearity, planarity,
    sphericity, omnivariance, anisotropy, eigen-entropy), from METRIC
    clouds; cells over [-xy_max, xy_max] in metric x / y, neighbourhoods
    by brute-force kNN (`ops/pointcloud.covariances_knn`). Returns (..., 6,
    h, w).

    The reference's `jnp.cbrt` is `pow(x, 1/3)` here (the eigenvalues are
    clamped positive); the two round differently, by an ulp or so."""
    from ..ops.pointcloud import covariances_knn

    batch, xyz, mask = _flat_batch(pc)
    B, N = mask.shape
    _, cov, valid = covariances_knn(PointCloud(xyz, mask), k=k)
    evals = torch.clamp(linalg3.eigvalsh3(cov), min=1e-12)      # ascending
    e1, e2, e3 = evals[..., 2], evals[..., 1], evals[..., 0]     # descending
    esum = e1 + e2 + e3
    p = evals / esum[..., None]
    feats = torch.stack([
        (e1 - e2) / e1, (e2 - e3) / e1, e3 / e1, torch.pow(e1 * e2 * e3, 1.0 / 3.0),
        (e1 - e3) / e1, -torch.sum(p * torch.log(p), dim=-1),
    ], dim=-1)                                                   # (B, N, 6)
    i = torch.clamp(((xyz[..., 1] / xy_max + 1.0) * 0.5 * h).to(torch.int64), 0, h - 1)
    j = torch.clamp(((xyz[..., 0] / xy_max + 1.0) * 0.5 * w).to(torch.int64), 0, w - 1)
    inb = (torch.abs(xyz[..., 0]) < xy_max) & (torch.abs(xyz[..., 1]) < xy_max)
    flat = (i * w + j + _cell_offset(B, h * w, xyz.device)).reshape(-1)
    wm = (mask & valid & inb).to(torch.float32)
    num = segment.scatter_sum(B * h * w, flat, (feats * wm[..., None]).reshape(-1, 6))
    den = segment.scatter_sum(B * h * w, flat, wm.reshape(-1))
    bev = num / torch.clamp(den[:, None], min=1.0)
    return bev.reshape(*batch, h, w, 6).movedim(-1, -3)
