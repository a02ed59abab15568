"""Trajectory and place-recognition metrics (port of
`mr_slam_tpu/eval/metrics.py`: `ate`, `_umeyama_align`,
`relative_pose_error`, `RecallResult`, `recall_at_n`, `make_positives`).

ATE against ground truth for trajectories, and recall@N / top-1% recall
for place recognition (`disco_ros/evaluate.py:59-198`), both batched."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import se3, so3
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


def relative_pose_error(est: Pose, true: Pose, delta: int = 1) -> torch.Tensor:
    """RPE over a fixed frame delta: translation drift per step."""
    n = est.t.shape[0]
    a, b = slice(0, n - delta), slice(delta, n)
    rel_est = se3.between(se3.index(est, a), se3.index(est, b))
    rel_true = se3.between(se3.index(true, a), se3.index(true, b))
    err = se3.between(rel_est, rel_true)
    return torch.sqrt(torch.mean(torch.sum(err.t ** 2, dim=-1)))


class RecallResult(NamedTuple):
    recall_at_n: torch.Tensor  # (N,) cumulative recall@1..N
    top1_percent: torch.Tensor


def recall_at_n(
    dists: torch.Tensor,      # (Q, D) descriptor distances query x database
    positives: torch.Tensor,  # (Q, D) bool ground-truth same-place pairs
    valid_q: torch.Tensor,    # (Q,) queries that have >= 1 positive
    max_n: int = 25,
) -> RecallResult:
    """recall@1..max_n and top-1% recall as one sort: a query scores at
    rank r if a ground-truth positive is among its r nearest entries.
    Equal distances rank by database index (a stable sort, as the
    reference's `argsort`)."""
    order = torch.sort(dists, dim=1, stable=True).indices
    hit_sorted = torch.gather(positives, 1, order)
    hits_at = torch.cumsum(hit_sorted[:, :max_n].to(torch.int32), dim=1) > 0
    w = valid_q.to(torch.float32)
    nq = torch.clamp(torch.sum(w), min=1.0)
    recall = torch.sum(hits_at * w[:, None], dim=0) / nq
    one_pct = max(dists.shape[1] // 100, 1)
    top1p = torch.sum(hit_sorted[:, :one_pct].any(dim=1) * w) / nq
    return RecallResult(recall_at_n=recall, top1_percent=top1p)


def make_positives(query_t: torch.Tensor, db_t: torch.Tensor, radius: float = 5.0,
                   exclude_self: int = -1) -> torch.Tensor:
    """Ground-truth positive mask by metric (x, y) distance (the
    pose-based ground truth of `generating_queries/*.py`)."""
    diff = query_t[:, None, :2] - db_t[None, :, :2]
    pos = torch.sqrt(torch.sum(diff * diff, dim=-1)) < radius
    if exclude_self >= 0:
        eye = torch.eye(query_t.shape[0], db_t.shape[0], dtype=torch.bool, device=pos.device)
        pos = pos & ~eye
    return pos
