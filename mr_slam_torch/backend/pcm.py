"""Pairwise Consistency Maximization inter-robot loop gating (port of
`mr_slam_tpu/backend/pcm.py`: `CHI2_6DOF`, `consistency_matrix`,
`filter_loops`, `max_clique`, `max_clique_greedy`, `intra_cycle_distances`).

Two loops are consistent when the cycle
Z_k^-1 (x_{a_k}^-1 x_{a_l}) Z_l (x_{b_l}^-1 x_{b_k}) is near identity
under a Mahalanobis norm; the largest mutually-consistent subset is the
maximum clique of the consistency graph. The (L, L) matrix is one
broadcast pose-algebra op on the device; the clique runs on the host in
the native solver (`mr_slam_torch/native.py`), which must build: the
greedy heuristic is a function of its own, never a fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..geometry import se3
from ..geometry.se3 import Pose

# chi2 inverse CDF at 6 dof for the reference's pcm_thresh table
# (`pairwise_consistency.cpp:7-38`: threshold prob -> chi2 value)
CHI2_6DOF = {
    0.01: 0.872,
    0.05: 1.635,
    0.10: 2.204,
    0.25: 3.455,
    0.50: 5.348,
    0.75: 7.840,
}


def consistency_matrix(
    poses_a: Pose,      # (L,) robot-a keyframe odometry poses at loop ends
    poses_b: Pose,      # (L,) robot-b keyframe odometry poses at loop ends
    meas: Pose,         # (L,) loop measurements: b-frame <- a-frame
    valid: torch.Tensor,  # (L,) bool
    rot_sigma: float = 0.1,
    trans_sigma: float = 0.5,
    idx_a: torch.Tensor | None = None,
    idx_b: torch.Tensor | None = None,
    odo_drift_t: float = 0.0,
    odo_drift_r: float = 0.0,
    step_len: float = 0.0,
) -> torch.Tensor:
    """(L, L) squared consistency distances (chi2-comparable, 6 dof),
    with the reference's drift-aware cycle covariance (variance grows
    with the keyframe steps inside the cycle). Invalid pairs +inf."""
    L = valid.shape[0]
    dev = valid.device
    if idx_a is None:
        steps = torch.zeros((L, L), device=dev)
    else:
        steps = (
            torch.abs(idx_a[:, None] - idx_a[None, :])
            + torch.abs(idx_b[:, None] - idx_b[None, :])
        ).to(torch.float32)

    def row(p: Pose) -> Pose:    # (L,) -> broadcast as k (rows)
        return Pose(p.R[:, None], p.t[:, None])

    def col(p: Pose) -> Pose:    # (L,) -> broadcast as l (columns)
        return Pose(p.R[None, :], p.t[None, :])

    A = se3.between(row(poses_a), col(poses_a))   # x_{a_k}^-1 x_{a_l}
    B = se3.between(col(poses_b), row(poses_b))   # x_{b_l}^-1 x_{b_k}
    cycle = se3.compose(
        se3.compose(se3.inverse(row(meas)), A), se3.compose(col(meas), B)
    )
    xi = se3.log(cycle)
    T2 = torch.sum(xi[..., 0:3] ** 2, dim=-1)
    R2 = torch.sum(xi[..., 3:6] ** 2, dim=-1)
    LEV2 = torch.maximum(torch.sum(A.t ** 2, dim=-1), torch.sum(B.t ** 2, dim=-1))
    var_t = (
        trans_sigma**2
        + steps * odo_drift_t**2
        + steps * odo_drift_r**2 * LEV2
        + odo_drift_r**2 * step_len**2 * steps**3 / 3.0
    )
    var_r = rot_sigma**2 + steps * odo_drift_r**2
    M = T2 / var_t + R2 / var_r
    ok = valid[:, None] & valid[None, :]
    return torch.where(ok, M, torch.inf)


def max_clique(adj: np.ndarray) -> np.ndarray:
    """Maximum clique via the native branch-and-bound solver."""
    return native.max_clique(np.asarray(adj, bool))


def max_clique_greedy(adj: np.ndarray, restarts: int = 32, seed: int = 0) -> np.ndarray:
    """Heuristic maximum clique on a boolean adjacency matrix (host):
    greedy by degree, then `restarts - 1` greedy passes in random vertex
    orders from `default_rng(seed)` (the flavour of the reference's
    `findCliqueHeu.cpp`). Returns the sorted indices of the largest
    clique found (the first found among equals)."""
    n = adj.shape[0]
    if n == 0:
        return np.zeros((0,), np.int64)
    adj = np.asarray(adj, bool).copy()
    np.fill_diagonal(adj, False)
    rng = np.random.default_rng(seed)
    best = np.zeros((0,), np.int64)
    degrees = adj.sum(1)
    for it in range(restarts):
        order = np.argsort(-degrees) if it == 0 else rng.permutation(n)
        clique: list[int] = []
        cand = np.ones(n, bool)
        for v in order:
            if cand[v]:
                clique.append(v)
                cand &= adj[v]
        c = np.array(sorted(clique), np.int64)
        if len(c) > len(best):
            best = c
    return best


def filter_loops(
    poses_a: Pose,
    poses_b: Pose,
    meas: Pose,
    valid,
    threshold: float = 0.872,
    rot_sigma: float = 0.1,
    trans_sigma: float = 0.5,
    idx_a=None,
    idx_b=None,
    odo_drift_t: float = 0.0,
    odo_drift_r: float = 0.0,
    step_len: float = 0.0,
) -> np.ndarray:
    """Full PCM pass for one robot pair: consistency matrix (device) ->
    max clique (host) -> (L,) bool accept mask."""
    dev = poses_a.t.device
    as_dev = lambda x: None if x is None else torch.as_tensor(np.asarray(x), device=dev)
    v = np.asarray(valid, bool)
    M = consistency_matrix(
        poses_a, poses_b, meas, torch.as_tensor(v, device=dev), rot_sigma, trans_sigma,
        idx_a=as_dev(idx_a), idx_b=as_dev(idx_b),
        odo_drift_t=odo_drift_t, odo_drift_r=odo_drift_r, step_len=step_len,
    )
    M = M.cpu().numpy()
    adj = (M < threshold) & (M.T < threshold)
    adj &= v[:, None] & v[None, :]
    keep = np.zeros(v.shape[0], bool)
    keep[max_clique(adj)] = True
    # a single valid loop has no pair support; the reference keeps it
    if v.sum() == 1:
        keep = v.copy()
    return keep


def intra_cycle_distances(
    poses: Pose,            # (L,) odometry poses at kf_a (same robot)
    poses_b: Pose,          # (L,) odometry poses at kf_b
    meas: Pose,             # (L,) loop measurements: b-frame <- a-frame
    idx_a: torch.Tensor,    # (L,) keyframe indices
    idx_b: torch.Tensor,
    trans_sigma: float = 0.5,
    rot_sigma: float = 0.1,
    odo_drift_t: float = 0.02,
    odo_drift_r: float = 0.002,
    step_len: float = 0.0,
) -> torch.Tensor:
    """(L,) single-loop odometry-cycle consistency of SAME-robot loops,
    || log(Z^-1 (x_a^-1 x_b)) ||^2 under `consistency_matrix`'s
    drift-aware cycle covariance: the odometry-space sanity gate for
    loops that never enter PCM."""
    odo = se3.between(poses, poses_b)
    xi = se3.log(se3.compose(se3.inverse(meas), odo))
    steps = torch.abs(idx_a - idx_b).to(torch.float32)
    lever2 = torch.sum(odo.t ** 2, dim=-1)
    var_t = (
        trans_sigma**2 + steps * odo_drift_t**2
        + steps * odo_drift_r**2 * lever2
        + odo_drift_r**2 * step_len**2 * steps**3 / 3.0
    )
    var_r = rot_sigma**2 + steps * odo_drift_r**2
    return torch.sum(xi[..., 0:3] ** 2, dim=-1) / var_t + torch.sum(xi[..., 3:6] ** 2, dim=-1) / var_r
