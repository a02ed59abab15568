"""Trajectory metrics (port of `mr_slam_tpu/eval/metrics.py`: `ate` and
`_umeyama_align`)."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import so3
from ..geometry.se3 import Pose


class ATEResult(NamedTuple):
    rmse: torch.Tensor
    mean: torch.Tensor
    max: torch.Tensor
    rot_rmse_deg: torch.Tensor


def _umeyama_align(est_t: torch.Tensor, true_t: torch.Tensor, mask: torch.Tensor):
    """SE(3) alignment (no scale) of est onto true (evo-style)."""
    w = mask.to(torch.float32)[:, None]
    n = torch.clamp(torch.sum(w), min=1.0)
    mu_e = torch.sum(est_t * w, dim=0) / n
    mu_t = torch.sum(true_t * w, dim=0) / n
    E = (est_t - mu_e) * w
    T = (true_t - mu_t) * w
    H = E.T @ T / n
    U, S, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.T @ U.T))
    ones = torch.ones_like(d)
    D = torch.diag(torch.stack([ones, ones, d]))
    R = Vt.T @ D @ U.T
    t = mu_t - R @ mu_e
    return R, t


def ate(est: Pose, true: Pose, mask: torch.Tensor | None = None, align: bool = False) -> ATEResult:
    """Absolute trajectory error. `align=True` removes the gauge with a
    rigid Umeyama fit first (merged multi-robot maps are anchored, so
    the default compares in the shared frame)."""
    n = est.t.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=est.t.device)
    est_t, est_R = est.t, est.R
    if align:
        R, t = _umeyama_align(est.t, true.t, mask)
        est_t = est.t @ R.T + t
        est_R = R @ est.R
    w = mask.to(torch.float32)
    nvalid = torch.clamp(torch.sum(w), min=1.0)
    d2 = torch.sum((est_t - true.t) ** 2, dim=-1) * w
    rot_err = torch.linalg.norm(so3.log(est_R @ true.R.transpose(-1, -2)), dim=-1) * w
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    return ATEResult(
        rmse=torch.sqrt(torch.sum(d2) / nvalid),
        mean=torch.sum(dist) / nvalid,
        max=torch.max(dist),
        rot_rmse_deg=torch.sqrt(torch.sum(rot_err**2) / nvalid) * 180.0 / math.pi,
    )
