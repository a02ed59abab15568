"""LOAM-style feature extraction on range images (port of
`mr_slam_tpu/ops/features.py`: `ScanFeatures`, `extract`).

A-LOAM's per-ring scalar loops (11-point curvature, 6 sectors with
sharp / flat picks by sorted curvature) over the whole (rings x azimuth)
image at once: curvature from rolled neighbours, then the top-k of each
sector.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .pointcloud import PointCloud, _order_key, park

_OFFSETS = (-5, -4, -3, -2, -1, 1, 2, 3, 4, 5)


class ScanFeatures(NamedTuple):
    corners: PointCloud      # high-curvature (edge) points
    surfs: PointCloud        # low-curvature (planar) points
    curvature: torch.Tensor  # (R, A) diagnostic


def _top_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, largest
    first and the lower index first among equal scores (the reference's
    `lax.top_k` rule, which `torch.topk` does not promise)."""
    return torch.topk(_order_key(-score), k, dim=-1, largest=False, sorted=True).indices


def _pick(xyz_s: torch.Tensor, score: torch.Tensor, k: int) -> PointCloud:
    idx = _top_k(score, k)
    pts = torch.gather(xyz_s, 2, idx[..., None].expand(*idx.shape, 3))
    ok = torch.isfinite(torch.gather(score, 2, idx))
    return park(PointCloud(pts.reshape(-1, 3), ok.reshape(-1)))


def extract(
    xyz: torch.Tensor,
    hit: torch.Tensor,
    n_sectors: int = 6,
    corners_per_sector: int = 4,
    surfs_per_sector: int = 8,
    corner_thresh: float = 0.1,
    surf_thresh: float = 0.1,
) -> ScanFeatures:
    """xyz: (R, A, 3) body-frame range image, hit: (R, A) valid mask.

    Curvature c = |sum_{j=-5..5, j!=0} (p_j - p)|^2 / max(range, 1)^2,
    neighbours wrapping in azimuth; a point is usable only with its whole
    11-point neighbourhood valid, a surf also away from range jumps of
    more than 0.5 m. Per ring and azimuth sector, the k largest
    curvatures above `corner_thresh` are corners and the k smallest below
    `surf_thresh` are surfs."""
    R, A, _ = xyz.shape
    diff_sum = -10.0 * xyz
    for j in _OFFSETS:
        diff_sum = diff_sum + torch.roll(xyz, -j, dims=1)
    rng = torch.linalg.norm(xyz, dim=-1)
    curv = torch.sum(diff_sum * diff_sum, dim=-1) / torch.clamp(rng, min=1.0) ** 2
    ok = hit
    for j in _OFFSETS:
        ok = ok & torch.roll(hit, -j, dims=1)
    jump = torch.abs(torch.roll(rng, -1, dims=1) - rng) > 0.5
    ok_surf = ok & ~jump & ~torch.roll(jump, 1, dims=1)

    W = A // n_sectors
    used = n_sectors * W  # the remainder columns are left out
    curv_s = curv[:, :used].reshape(R, n_sectors, W)
    ok_s = ok[:, :used].reshape(R, n_sectors, W)
    ok_surf_s = ok_surf[:, :used].reshape(R, n_sectors, W)
    xyz_s = xyz[:, :used].reshape(R, n_sectors, W, 3)

    corner_score = torch.where(ok_s & (curv_s > corner_thresh), curv_s, -torch.inf)
    surf_score = torch.where(ok_surf_s & (curv_s < surf_thresh), -curv_s, -torch.inf)
    return ScanFeatures(
        corners=_pick(xyz_s, corner_score, corners_per_sector),
        surfs=_pick(xyz_s, surf_score, surfs_per_sector),
        curvature=curv,
    )
