"""Decentralized Gauss-Seidel / Jacobi pose-graph optimization (port of
`mr_slam_tpu/backend/gauss_seidel.py`: `GSConfig`, `_masked_cg`,
`_robot_edge_gate`, `_rotation_system`, `optimize`).

The reference's distributed-mapper (`distributed_mapper.cpp` and
`distributedOptimizer`, `distributed_mapper_utils.cpp:482+`) never
assembles the global system: each robot repeatedly solves only ITS
subgraph, with its neighbours' current estimates as fixed priors over
the separator (inter-robot) edges — first the linear chordal rotation
system (`estimateRotation`, `distributed_mapper.cpp:117-189`), then the
chordal pose system (`estimatePoses`, :220-305). Flagged initialization
lets a robot join the sweep only once a neighbour is initialized; the
update is Gauss-Seidel (apply at once) or Jacobi (apply after the
sweep), with over-relaxation `gamma`.

Each robot's block solve is matrix-free CG over the SAME fixed-capacity
arrays with only that robot's rows free; every other node's
contribution is folded into the right-hand side. It runs in one process
with no collectives: `distributed.py` is the multi-process optimizer,
this module the algorithmic cross-check (with the same `robust_delta`
both share a fixed point on consistent graphs). Every scatter goes
through one `segment.ScatterPlan` (`chordal`), so a rerun on the card is
bit-identical.

The reference compiles the whole solve (`@jax.jit optimize`, its sweeps
two `lax.scan`s, the robot loop unrolled in each). Here the solve is cut
into sweeps on the same operations in the same order: `rot_sweeps` x
`rotation_sweep`, `so3.project`, `pose_sweeps` x `pose_sweep`,
`so3.project`. `optimize` runs them through `runtime/solve_graph`'s
Gauss-Seidel runner, which replays each sweep from a CUDA graph on the
card (a default solve is ~90,000 small kernels: launch-bound when run op
by op) and keeps the projections' SVDs eager between the stages. A
sweep's index may be a Python int or a 0-d integer tensor on the device
(the runner's counter, which its graphs advance): the flagged-init gate
compares `robots <= sweep`, the same booleans either way.
`_optimize_eager` is the solve op by op, the oracle the runner is held
to bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import so3
from ..geometry.se3 import Pose
from . import chordal
from .factor_graph import FactorGraph


class GSConfig(NamedTuple):
    rot_sweeps: int = 25        # rotation-stage sweeps over all robots
    pose_sweeps: int = 25       # pose-stage sweeps
    cg_iters: int = 15          # CG iterations per block solve
    gamma: float = 1.0          # over-relaxation (1 = plain GS)
    jacobi: bool = False        # postUpdate (Jacobi) vs incUpdate (GS)
    flagged_init: bool = True   # gate separators until both ends joined
    anchor_weight: float = 1e6
    damping: float = 1e-6
    robust_delta: float = 1.0   # Cauchy scale for loop edges (matches
                                # chordal.PGOConfig default); <=0 off


def _masked_cg(A, b: torch.Tensor, mask: torch.Tensor, iters: int) -> torch.Tensor:
    """CG for A x = b restricted to `mask` rows (the others held at 0).
    A must be linear; mask (b.shape[0],) broadcasts over b's rows."""
    m = mask.reshape(mask.shape[0], *([1] * (b.dim() - 1))).to(b.dtype)

    def Am(x):
        return m * A(m * x)

    x = torch.zeros_like(b)
    r = m * b
    p = r
    rs = torch.sum(r * r)
    for _ in range(iters):
        Ap = Am(p)
        alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-12)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r)
        beta = rs_new / torch.clamp(rs, min=1e-12)
        p = r + beta * p
        rs = rs_new
    return x


def _robot_edge_gate(g: FactorGraph, initialized: torch.Tensor) -> torch.Tensor:
    """Flagged-init gate: a separator (inter-robot) edge takes part only
    when the robots of both endpoints are initialized; intra-robot
    edges always do (`distributed_mapper.cpp:157-163`)."""
    ri = g.node_robot[g.edge_i]
    rj = g.node_robot[g.edge_j]
    return (ri == rj) | (initialized[ri] & initialized[rj])


def _rotation_system(g: FactorGraph, gate: torch.Tensor, anchors: torch.Tensor, aw: float,
                     scatter):
    """The linear chordal rotation operator and its anchor right-hand
    side on X in R^{N x 3 x 3}: A(X) = the gradient of
    sum_e w_e |X_j - X_i Rij|_F^2 plus the anchor terms."""
    w = torch.where(g.edge_valid & gate, g.edge_w_rot, 0.0)
    a = anchors.to(torch.float32) * aw

    def A(X):
        return chordal._rotation_scatter(g, w, X, scatter) + a[:, None, None] * X

    return A, a[:, None, None] * g.poses.R


def initialized_at(sweep, n_robots: int, config: GSConfig, device) -> torch.Tensor:
    """(n_robots,) bool: the robots initialized at global sweep `sweep`
    (an int or a 0-d integer tensor). With flagged initialization robot 0
    starts initialized and robot r joins at sweep r."""
    if not config.flagged_init:
        return torch.ones((n_robots,), dtype=torch.bool, device=device)
    return torch.arange(n_robots, device=device) <= sweep


def _sweep_blocks(x: torch.Tensor, n_robots: int, config: GSConfig, block) -> torch.Tensor:
    """One sweep over the robots' blocks in robot order: Gauss-Seidel
    applies each block at once, Jacobi sums the blocks' moves from one
    state."""
    if config.jacobi:
        delta = torch.zeros_like(x)
        for r in range(n_robots):
            delta = delta + block(x, r) - x
        return x + delta
    for r in range(n_robots):
        x = block(x, r)
    return x


def rotation_sweep(X: torch.Tensor, sweep, g: FactorGraph, anchors: torch.Tensor,
                   n_robots: int, config: GSConfig, scatter) -> torch.Tensor:
    """One sweep of stage 1 (the reference's `rot_sweep`): every robot's
    block of the linear chordal rotation system, its neighbours'
    rotations held fixed. X (N, 3, 3); returns X after the sweep."""
    init = initialized_at(sweep, n_robots, config, X.device)
    A, b_anchor = _rotation_system(g, _robot_edge_gate(g, init), anchors,
                                   config.anchor_weight, scatter)

    def block(X, r):
        m = (g.node_robot == r) & g.node_valid
        mN = m[:, None, None].to(X.dtype)
        X_fixed = (1.0 - mN) * X
        x = _masked_cg(A, b_anchor - A(X_fixed), m, config.cg_iters)
        X_new = X_fixed + x
        # uninitialized robots keep their estimate
        upd = config.gamma * init[r].to(X.dtype)
        return X + upd * (X_new - X) * mN

    return _sweep_blocks(X, n_robots, config, block)


def pose_sweep(R: torch.Tensor, t: torch.Tensor, sweep, g: FactorGraph, aw: torch.Tensor,
               n_robots: int, config: GSConfig, scatter):
    """One sweep of stage 2 (the reference's `pose_sweep`) from (R, t):
    one GN linearization, then every robot's block of the normal
    equations with its neighbours' (phi, dt) held at 0, i.e. their
    current poses as priors. `sweep` counts the stage's sweeps; the gate
    reads the global counter `sweep + rot_sweeps`. `aw` (N,): the
    anchors' prior weights (`anchors * config.anchor_weight`) toward
    `g.poses`. Returns (R, t) after the sweep."""
    N = g.node_capacity
    anchor_R0, anchor_t0 = g.poses.R, g.poses.t
    # the global sweep counter: with rot_sweeps >= n_robots - 1 every robot has joined
    init = initialized_at(sweep + config.rot_sweeps, n_robots, config, t.device)
    gate = _robot_edge_gate(g, init)
    r_res, J = chordal._residuals_and_jac(R, t, g)
    # chordal.optimize's Cauchy IRLS loop weights: a shared fixed point
    row_w = chordal._edge_block_weight(g, r_res, config.robust_delta)
    row_w = row_w * gate.to(torch.float32)[:, None]

    def Hx(x):
        return chordal._jtwj(J, row_w, x, g, scatter) + (aw[:, None] + config.damping) * x

    b = -chordal._jtw(J, row_w * r_res, scatter)
    phi_anchor = so3.log(R @ anchor_R0.transpose(-1, -2))
    b = b - aw[:, None] * torch.cat([phi_anchor, t - anchor_t0], dim=1)

    def block(x, r):
        m = (g.node_robot == r) & g.node_valid
        mN = m[:, None].to(x.dtype)
        x_fixed = (1.0 - mN) * x
        sol = _masked_cg(Hx, b - Hx(x_fixed), m, config.cg_iters)
        x_new = x_fixed + sol
        upd = config.gamma * init[r].to(x.dtype)
        return x + upd * (x_new - x) * mN

    x = _sweep_blocks(torch.zeros((N, 6), dtype=t.dtype, device=t.device), n_robots, config,
                      block)
    R_new = so3.exp(x[:, 0:3]) @ R
    t_new = t + x[:, 3:6]
    R = torch.where(g.node_valid[:, None, None], R_new, R)
    t = torch.where(g.node_valid[:, None], t_new, t)
    return R, t


def optimize(
    g: FactorGraph,
    anchors: torch.Tensor,
    n_robots: int,
    config: GSConfig = GSConfig(),
) -> Pose:
    """The two-stage decentralized scheme; returns optimized poses. The
    sweep order is robot id. Runs through the runner of the solve's key
    (`runtime/solve_graph`: CUDA-graph replays on the card), bit-equal to
    `_optimize_eager`."""
    from ..runtime import solve_graph

    return solve_graph.solve_gauss_seidel(g, anchors, n_robots, config)


def _optimize_eager(
    g: FactorGraph,
    anchors: torch.Tensor,
    n_robots: int,
    config: GSConfig = GSConfig(),
) -> Pose:
    """`optimize` op by op, its sweep indices Python ints: the oracle that
    the runner's solve equals bit for bit (the tests and `chip_smoke.py`
    call it)."""
    scatter = chordal.scatter_plan(g)
    X = g.poses.R
    for sweep in range(config.rot_sweeps):
        X = rotation_sweep(X, sweep, g, anchors, n_robots, config, scatter)
    R = so3.project(X)
    R = torch.where(g.node_valid[:, None, None], R, g.poses.R)
    aw = anchors.to(torch.float32) * config.anchor_weight
    t = g.poses.t
    for sweep in range(config.pose_sweeps):
        R, t = pose_sweep(R, t, sweep, g, aw, n_robots, config, scatter)
    return Pose(so3.project(R), t)
