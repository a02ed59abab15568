"""FastHistogram place descriptor — range histogram + Wasserstein match
(port of `mr_slam_tpu/loop/fast_histogram.py`): the normalized histogram
of point ranges, matched by the 1-Wasserstein (cumulative-difference)
distance. The cheapest baseline, the floor of a recall evaluation."""
from __future__ import annotations

import torch

from ..ops import segment
from ..ops.pointcloud import PointCloud


def describe(pc: PointCloud, n_bins: int = 128, r_max: float = 80.0) -> torch.Tensor:
    """Clouds (..., N, 3) -> normalized range histograms (..., n_bins)."""
    batch, n = pc.xyz.shape[:-2], pc.xyz.shape[-2]
    xyz = pc.xyz.reshape(-1, n, 3)
    r = torch.sqrt(torch.sum(xyz * xyz, dim=-1))
    m = pc.mask.reshape(-1, n) & (r < r_max)
    bi = torch.clamp((r / r_max * n_bins).to(torch.int64), 0, n_bins - 1)
    B = xyz.shape[0]
    flat = bi + torch.arange(B, device=xyz.device)[:, None] * n_bins
    hist = segment.count(B * n_bins, flat, m).to(torch.float32).reshape(B, n_bins)
    hist = hist / torch.clamp(torch.sum(hist, dim=-1, keepdim=True), min=1.0)
    return hist.reshape(*batch, n_bins)


def distance(query: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    """1-Wasserstein distance between histograms: queries (..., B),
    database (D, B) -> (..., D)."""
    cq = torch.cumsum(query, dim=-1)
    cd = torch.cumsum(database, dim=-1)
    return torch.sum(torch.abs(cd - cq[..., None, :]), dim=-1) / query.shape[-1]
