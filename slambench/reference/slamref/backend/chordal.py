"""Two-stage chordal pose-graph optimization, matrix-free (port of
`mr_slam_tpu/backend/chordal.py`: `PGOConfig`, `rotation_init`,
`optimize`, `_preduce`).

Stage 1 solves the chordal rotation relaxation by CG and projects to
SO(3); stage 2 runs Gauss-Newton on the BetweenChordalFactor residuals
with Jacobi-preconditioned CG, Cauchy IRLS weights on loop edges.
Every H x product is a gather over edge endpoints, a per-edge Jacobian
contraction and a scatter-add back to nodes through one
`segment.ScatterPlan` per solve (the edge set is fixed during a solve):
a fixed summation order, so reruns on the card are bit-identical.

The reference compiles the whole solve (`@jax.jit optimize`, its CG
loops `lax.scan`s). Here the solve is cut into stages on the same
operations in the same order: `rotation_cg` (stage 1 up to the
projection), `so3.project`, then `gn_iters` x `gn_step`, then
`so3.project`. Without `group`, `optimize` runs them through
`runtime/solve_graph`'s runner, which replays the CG stage and each GN
step from CUDA graphs on the card (a default solve is 60 + 12 x 40 CG
steps, ~20,000 small kernels: launch-bound when run op by op) and keeps
the projections' SVDs eager between them. `_optimize_eager` is the
solve op by op, the oracle the runner is held to bit for bit.

With `group` (a `torch.distributed` process group) the edge arrays are
this rank's block of the graph's edges and the node arrays are
replicated: every edge scatter is summed over the group's ranks
(`_preduce`, one all-reduce), so each rank solves the whole system and
every rank gets the same bits. The CG dot products are over replicated
node vectors and are not reduced, as in the reference. With
`group=None` nothing is reduced: the single-process solve.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import so3
from ..geometry.se3 import Pose
from ..ops import segment
from .factor_graph import FactorGraph


class PGOConfig(NamedTuple):
    rot_cg_iters: int = 60       # stage-1 CG iterations
    gn_iters: int = 12           # stage-2 outer GN iterations
    pose_cg_iters: int = 40      # CG iterations per GN step
    anchor_weight: float = 1e6   # prior strength (ref prior noise 1e-15)
    robust_delta: float = 1.0    # Cauchy scale for loop edges; <=0 off
    damping: float = 1e-5


def _edge_weights(g: FactorGraph):
    w = g.edge_valid.to(torch.float32)
    return w * g.edge_w_rot, w * g.edge_w_trans


def _preduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum edge-scatter partials over the ranks of `group` (`x` itself
    when there is none)."""
    if group is None:
        return x
    raise ValueError("the reference solves in one process")


def scatter_plan(g: FactorGraph) -> segment.ScatterPlan:
    """The node scatter of a solve: per-edge values at edge_i, then at
    edge_j, summed into (node_capacity, ...). Unused edge slots carry
    zero weight, so every value they scatter is zero."""
    return segment.ScatterPlan(
        torch.cat([g.edge_i, g.edge_j]), g.node_capacity,
        keep=torch.cat([g.edge_valid, g.edge_valid]),
    )


def rotation_init(
    g: FactorGraph,
    anchors: torch.Tensor,
    iters: int = 60,
    anchor_weight: float = 1e3,
    scatter: segment.ScatterPlan | None = None,
    group=None,
) -> torch.Tensor:
    """Solve min sum_e w_e |X_j - X_i Rij|_F^2 (+ anchored rotations) over
    X in R^{N x 3 x 3} by CG on the normal equations, then project to
    SO(3). `anchor_weight` is softer than the pose stage's (a 1e6 anchor
    row stalls CG from a warm start). `group`: see the module docstring."""
    return so3.project(rotation_cg(g, anchors, iters, anchor_weight, scatter, group))


def rotation_cg(
    g: FactorGraph,
    anchors: torch.Tensor,
    iters: int = 60,
    anchor_weight: float = 1e3,
    scatter: segment.ScatterPlan | None = None,
    group=None,
) -> torch.Tensor:
    """`rotation_init` up to its projection: the CG iterate X (N, 3, 3)."""
    scatter = scatter or scatter_plan(g)
    w_rot, _ = _edge_weights(g)
    anchor_R = g.poses.R
    aw = anchors.to(torch.float32) * anchor_weight

    def A(X):
        return _preduce(_rotation_scatter(g, w_rot, X, scatter), group) + aw[:, None, None] * X

    b = aw[:, None, None] * anchor_R
    X = anchor_R  # warm start from the current estimate
    r = b - A(X)
    p = r
    rs = torch.sum(r * r)
    for _ in range(iters):
        Ap = A(p)
        alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-12)
        X = X + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r)
        beta = rs_new / torch.clamp(rs, min=1e-12)
        p = r + beta * p
        rs = rs_new
    return X


def _rotation_scatter(g: FactorGraph, w: torch.Tensor, X: torch.Tensor,
                      scatter: segment.ScatterPlan) -> torch.Tensor:
    """The edge part of the rotation operator: the gradient of
    sum_e w_e |X_j - X_i Rij|_F^2 scattered to the nodes."""
    Rij = g.edge_meas.R
    wr = w[:, None, None]
    d = X[g.edge_j] - X[g.edge_i] @ Rij
    gi = -(d @ Rij.transpose(-1, -2))
    return scatter(wr * gi, wr * d)


def _hat_cols(M: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 9, 3) stack of -hat(column_k)."""
    cols = M.transpose(-1, -2)
    return -so3.hat(cols).reshape(*M.shape[:-2], 9, 3)


def _residuals_and_jac(R: torch.Tensor, t: torch.Tensor, g: FactorGraph):
    """Per-edge chordal residual (E, 12) and Jacobian blocks wrt
    (phi_i, dt_i, phi_j, dt_j), each (E, 12, 3):
    e_R = vec(R_i Rij - R_j), e_t = R_i tij + t_i - t_j."""
    ei, ej = g.edge_i, g.edge_j
    Ri, Rj = R[ei], R[ej]
    ti, tj = t[ei], t[ej]
    Rij, tij = g.edge_meas.R, g.edge_meas.t
    Mi = Ri @ Rij
    e_R = (Mi - Rj).transpose(-1, -2).reshape(-1, 9)  # vec by columns
    ri_tij = (Ri @ tij[..., None])[..., 0]
    e_t = ri_tij + ti - tj
    E = ei.shape[0]
    z93 = torch.zeros((E, 9, 3), dtype=R.dtype, device=R.device)
    z33 = torch.zeros((E, 3, 3), dtype=R.dtype, device=R.device)
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device).expand(E, 3, 3)
    J = {
        "phi_i": torch.cat([_hat_cols(Mi), -so3.hat(ri_tij)], dim=1),
        "dt_i": torch.cat([z93, eye3], dim=1),
        "phi_j": torch.cat([-_hat_cols(Rj), z33], dim=1),
        "dt_j": torch.cat([z93, -eye3], dim=1),
    }
    return torch.cat([e_R, e_t], dim=1), J


def _edge_block_weight(g: FactorGraph, r: torch.Tensor, robust_delta: float):
    """(E, 12) per-row weights: rotation rows w_rot, translation rows
    w_trans, scaled by a Cauchy IRLS factor on loop edges."""
    w_rot, w_trans = _edge_weights(g)
    row_w = torch.cat(
        [w_rot[:, None].expand(-1, 9), w_trans[:, None].expand(-1, 3)], dim=1
    )
    if robust_delta > 0:
        e2 = torch.sum(r * r * row_w, dim=1)
        cw = 1.0 / (1.0 + e2 / (robust_delta**2))
        cw = torch.where(g.edge_kind != 0, cw, 1.0)
        row_w = row_w * cw[:, None]
    return row_w


def _jt(Jb: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum('erc,er->ec')."""
    return (Jb.transpose(-1, -2) @ v[..., None])[..., 0]


def _jtw(J, v: torch.Tensor, scatter) -> torch.Tensor:
    """J^T v scattered to the nodes: (N, 6) from per-edge rows v (E, 12)."""
    bi = torch.cat([_jt(J["phi_i"], v), _jt(J["dt_i"], v)], dim=1)
    bj = torch.cat([_jt(J["phi_j"], v), _jt(J["dt_j"], v)], dim=1)
    return scatter(bi, bj)


def _jtwj(J, row_w: torch.Tensor, x: torch.Tensor, g: FactorGraph, scatter) -> torch.Tensor:
    """J^T W J x scattered to the nodes, x (N, 6) [phi, dt]."""
    xi, xj = x[g.edge_i], x[g.edge_j]
    Jx = (
        (J["phi_i"] @ xi[:, 0:3, None])[..., 0]
        + (J["dt_i"] @ xi[:, 3:6, None])[..., 0]
        + (J["phi_j"] @ xj[:, 0:3, None])[..., 0]
        + (J["dt_j"] @ xj[:, 3:6, None])[..., 0]
    )
    return _jtw(J, row_w * Jx, scatter)


def _hessian_diag(J, row_w, scatter):
    """(N, 6) diagonal of the GN normal matrix (Jacobi preconditioner)."""
    di = torch.cat([_jt(J["phi_i"] ** 2, row_w), _jt(J["dt_i"] ** 2, row_w)], dim=1)
    dj = torch.cat([_jt(J["phi_j"] ** 2, row_w), _jt(J["dt_j"] ** 2, row_w)], dim=1)
    return scatter(di, dj)


def gn_step(R: torch.Tensor, t: torch.Tensor, g: FactorGraph, aw: torch.Tensor,
            config: PGOConfig, scatter: segment.ScatterPlan):
    """One Gauss-Newton step of the second stage from (R, t), the loop
    body of `_optimize_eager` without a process group: (R, t) after the
    step. `aw` (N,): the anchors' prior weights (`anchors *
    config.anchor_weight`)."""
    N = g.node_capacity
    anchor_R0, anchor_t0 = g.poses.R, g.poses.t
    r, J = _residuals_and_jac(R, t, g)
    row_w = _edge_block_weight(g, r, config.robust_delta)

    def Hx(x):
        return _jtwj(J, row_w, x, g, scatter) + (aw[:, None] + config.damping) * x

    b = -_jtw(J, row_w * r, scatter)
    # anchor residual pull (keep anchors at their initial pose)
    phi_anchor = so3.log(R @ anchor_R0.transpose(-1, -2))
    b = b - aw[:, None] * torch.cat([phi_anchor, t - anchor_t0], dim=1)
    diag = _hessian_diag(J, row_w, scatter) + aw[:, None] + config.damping
    Minv = 1.0 / torch.clamp(diag, min=1e-8)

    x = torch.zeros((N, 6), device=t.device)
    r_ = b
    z = Minv * r_
    p = z
    rz = torch.sum(r_ * z)
    for _ in range(config.pose_cg_iters):
        Ap = Hx(p)
        alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-12)
        x = x + alpha * p
        r_ = r_ - alpha * Ap
        z = Minv * r_
        rz_new = torch.sum(r_ * z)
        beta = rz_new / torch.clamp(rz, min=1e-12)
        p = z + beta * p
        rz = rz_new
    R_new = so3.exp(x[:, 0:3]) @ R
    t_new = t + x[:, 3:6]
    R = torch.where(g.node_valid[:, None, None], R_new, R)
    t = torch.where(g.node_valid[:, None], t_new, t)
    return R, t


def _optimize_eager(
    g: FactorGraph,
    anchors: torch.Tensor,
    config: PGOConfig = PGOConfig(),
    group=None,
) -> Pose:
    """`optimize` op by op: the solve with `group`, and without it the
    oracle that the runner's solve equals bit for bit (the tests and
    `chip_smoke.py` call it; no path of the card does without `group`)."""
    N = g.node_capacity
    scatter = scatter_plan(g)
    R = rotation_init(g, anchors, config.rot_cg_iters, scatter=scatter, group=group)
    R = torch.where(g.node_valid[:, None, None], R, g.poses.R)
    t = g.poses.t
    aw = anchors.to(torch.float32) * config.anchor_weight
    anchor_R0, anchor_t0 = g.poses.R, g.poses.t

    for _ in range(config.gn_iters):
        r, J = _residuals_and_jac(R, t, g)
        row_w = _edge_block_weight(g, r, config.robust_delta)

        def Hx(x):
            return _preduce(_jtwj(J, row_w, x, g, scatter), group) \
                + (aw[:, None] + config.damping) * x

        b = -_preduce(_jtw(J, row_w * r, scatter), group)
        # anchor residual pull (keep anchors at their initial pose)
        phi_anchor = so3.log(R @ anchor_R0.transpose(-1, -2))
        b = b - aw[:, None] * torch.cat([phi_anchor, t - anchor_t0], dim=1)
        diag = _preduce(_hessian_diag(J, row_w, scatter), group) + aw[:, None] + config.damping
        Minv = 1.0 / torch.clamp(diag, min=1e-8)

        x = torch.zeros((N, 6), device=t.device)
        r_ = b
        z = Minv * r_
        p = z
        rz = torch.sum(r_ * z)
        for _ in range(config.pose_cg_iters):
            Ap = Hx(p)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-12)
            x = x + alpha * p
            r_ = r_ - alpha * Ap
            z = Minv * r_
            rz_new = torch.sum(r_ * z)
            beta = rz_new / torch.clamp(rz, min=1e-12)
            p = z + beta * p
            rz = rz_new
        R_new = so3.exp(x[:, 0:3]) @ R
        t_new = t + x[:, 3:6]
        R = torch.where(g.node_valid[:, None, None], R_new, R)
        t = torch.where(g.node_valid[:, None], t_new, t)
    return Pose(so3.project(R), t)
