"""Pairwise Consistency Maximization inter-robot loop gating (port of
`mr_slam_tpu/backend/pcm.py`: `consistency_matrix`, `filter_loops`,
`max_clique`).

Two loops are consistent when the cycle
Z_k^-1 (x_{a_k}^-1 x_{a_l}) Z_l (x_{b_l}^-1 x_{b_k}) is near identity
under a Mahalanobis norm; the largest mutually-consistent subset is the
maximum clique of the consistency graph. The (L, L) matrix is one
broadcast pose-algebra op on the device; the clique runs on the host in
the native solver (`mr_slam_torch/native.py`), which must build.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..geometry import se3
from ..geometry.se3 import Pose


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
