"""FAST-LIO2-style lidar-inertial odometry (port of `mr_slam_tpu/
frontend/lio.py`: `ImuSample`, `LioState`, `LioConfig`, `init`,
`imu_init`, `propagate`, `undistort`, `update`, `step`).

A 24-dof error-state filter dx = [dphi, dp, dv, dbg, dba, dphi_e, dp_e,
dgrav] (left / world-frame rotation perturbation R <- exp(dphi) R; the
lidar-IMU extrinsic R_li <- exp(dphi_e) R_li, t_li <- t_li + dp_e; a
gravity tangent renormalized to 9.81), the reference system's IKFoM
23-state with an online-calibrated extrinsic and gravity:

  * `propagate` integrates an IMU packet and carries the covariance
    through P <- F P F^T + Q per sample; the transition matrices of the
    whole packet are built at once, with a handful of block writes, and
    the recursion is three launches per sample;
  * `update` is the iterated measurement update as MAP Gauss-Newton with
    the propagated prior, ||dx||^2_{P^-1} + sum_i ||h_i||^2_R, against
    point-to-plane residuals of planes pooled from the map's cells; its
    24x24 solves are the column-wise LDL^T of `ops/linalg3` (no cuSOLVER
    call, so no host sync); the posterior contracts to (J^T W J +
    P^-1)^-1.

Scans stay in the LIDAR frame; the filter pose (R, p) is world <- IMU,
and `lidar_pose()` composes the extrinsic in. `LioState.frame` is a
Python integer beside the device state, so the reference's `lax.cond`
on the first frame is a host `if` with no sync. Runs in float32 with
TF32 off (`precision.pin_f32`), the reference's `accurate` policy.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..devconst import const
from ..geometry import se3, so3
from ..geometry.se3 import Pose
from ..ops import linalg3, registration, voxel_grid
from ..ops import pointcloud as pcl

GRAVITY = (0.0, 0.0, -9.81)
_DOF = 24  # [dphi, dp, dv, dbg, dba, dphi_e, dp_e, dgrav]
_BOUNDS = ((-150.0, -150.0, -150.0), (150.0, 150.0, 150.0))


class ImuSample(NamedTuple):
    gyro: torch.Tensor   # (..., 3) rad/s
    acc: torch.Tensor    # (..., 3) m/s^2 (specific force, body frame)
    dt: torch.Tensor     # (...,) s


class LioState(NamedTuple):
    R: torch.Tensor      # (3, 3) world <- IMU body
    p: torch.Tensor      # (3,)
    v: torch.Tensor      # (3,)
    bg: torch.Tensor     # (3,) gyro bias
    ba: torch.Tensor     # (3,) accel bias
    R_li: torch.Tensor   # (3, 3) IMU <- lidar extrinsic rotation
    t_li: torch.Tensor   # (3,) IMU <- lidar extrinsic translation
    grav: torch.Tensor   # (3,) gravity vector, world frame
    P: torch.Tensor      # (24, 24) error covariance
    grid: voxel_grid.VoxelGrid
    frame: int           # frames processed (host)

    def pose(self) -> Pose:
        """world <- IMU body."""
        return Pose(self.R, self.p)

    def lidar_pose(self) -> Pose:
        """world <- lidar: T_wb o T_bl."""
        return Pose(self.R @ self.R_li, self.R @ self.t_li + self.p)


class LioConfig(NamedTuple):
    map_leaf: float = 1.0
    insert_leaf: float = 0.15
    scan_leaf: float = 0.4
    scan_capacity: int = 4096
    insert_capacity: int = 16384
    table_size: int = 1 << 17
    map_radius: float = 120.0
    iters: int = 4                 # IEKF / GN iterations
    max_corr_dist: float = 1.0
    gyro_noise: float = 1e-3       # PSD (rad^2/s)
    acc_noise: float = 1e-2        # PSD (m^2/s^3)
    bias_rw: float = 1e-5          # bias random-walk PSD
    lidar_noise: float = 0.05      # per-residual std (m)
    estimate_extrinsics: bool = False  # online R_li / t_li refinement
    extrinsic_prior: float = 1e-4  # initial extrinsic variance when estimating
    extrinsic_rw: float = 1e-7     # extrinsic random walk (keeps it plastic)
    estimate_gravity: bool = False  # refine the gravity vector online
    gravity_prior: float = 1e-3    # initial gravity variance (m^2/s^4)
    gravity_rw: float = 0.0        # gravity random walk (0: constant)
    extrinsic_step: float = 2e-3   # trust region: the largest extrinsic
                                   # correction per GN iteration (rad / m);
                                   # scan-to-map residuals cannot tell dphi
                                   # from R dphi_e within one heading, and
                                   # unclamped the map's registration error
                                   # drains into the extrinsic


def init(config: LioConfig, origin: Pose | None = None, extrinsic: Pose | None = None,
         device=None) -> LioState:
    """A filter at `origin` (identity if None) with an empty map, on the
    origin's device (else `device`). `extrinsic`: the initial IMU <- lidar
    transform, identity if None; refined online from `extrinsic_prior`
    with `config.estimate_extrinsics`, held fixed otherwise."""
    if origin is None:
        origin = se3.identity(device=device)
    dev = origin.t.device
    if extrinsic is None:
        extrinsic = se3.identity(device=dev)
    P0 = torch.zeros((_DOF, _DOF), device=dev)
    P0[:15, :15] = torch.eye(15, device=dev) * 1e-2
    P0[9:15, 9:15] = torch.eye(6, device=dev) * 1e-3  # biases: uncertain enough to move
    if config.estimate_extrinsics:
        P0[15:21, 15:21] = torch.eye(6, device=dev) * config.extrinsic_prior
    if config.estimate_gravity:
        P0[21:24, 21:24] = torch.eye(3, device=dev) * config.gravity_prior
    zeros = torch.zeros(3, device=dev)
    return LioState(
        R=origin.R, p=origin.t, v=zeros, bg=zeros, ba=zeros,
        R_li=extrinsic.R.to(dev), t_li=extrinsic.t.to(dev),
        grav=const(GRAVITY, dev).clone(), P=P0,
        grid=voxel_grid.empty(config.map_leaf, config.table_size, dev),
        frame=0,
    )


def imu_init(state: LioState, imu: ImuSample) -> LioState:
    """Static initialization from a rest prefix (`IMU_init`): the gyro
    mean is the gyro bias, the accel mean's direction is gravity (its
    magnitude pinned to 9.81); the accel bias along gravity is
    unobservable at rest and stays zero."""
    w = imu.dt / torch.clamp(torch.sum(imu.dt), min=1e-9)
    gyro_mean = torch.sum(imu.gyro * w[:, None], dim=0)
    acc_mean = torch.sum(imu.acc * w[:, None], dim=0)
    g_dir = -(state.R @ acc_mean)   # at rest f = -R^T g
    g = g_dir * (9.81 / torch.clamp(torch.linalg.norm(g_dir), min=1e-9))
    return state._replace(bg=gyro_mean, grav=g)


def propagate(state: LioState, imu: ImuSample, config: LioConfig):
    """Forward-propagate mean and covariance through an IMU packet (the
    leaves' leading axis is time). Returns (state', (Rs, ps) the
    per-sample poses after each sample, for undistortion).

    Per sample, with R the attitude before it and R' after:
      dphi' = dphi - R' dbg dt,  dp' = dp + dv dt,
      dv' = dv - [R (a - ba)]x dphi dt - R dba dt + dgrav dt,
    the biases random-walk and the extrinsic is constant."""
    S = imu.dt.shape[0]
    dev = imu.dt.device
    dt = imu.dt
    a = imu.acc - state.ba
    dR = so3.exp((imu.gyro - state.bg) * dt[:, None])
    R = state.R
    Rs_before, Rs = [], []
    for k in range(S):
        Rs_before.append(R)
        R = R @ dR[k]
        Rs.append(R)
    R_b, R_a = torch.stack(Rs_before), torch.stack(Rs)
    Ra = (R_b @ a[:, :, None])[..., 0]                 # R (a - ba) per sample
    acc_w = Ra + state.grav
    half_acc_dt2 = 0.5 * acc_w * (dt * dt)[:, None]
    acc_dt = acc_w * dt[:, None]
    p, v = state.p, state.v
    ps = []
    for k in range(S):
        p = p + v * dt[k] + half_acc_dt2[k]
        v = v + acc_dt[k]
        ps.append(p)
    # the packet's transition matrices, block by block
    eye3 = torch.eye(3, device=dev)
    F = torch.eye(_DOF, device=dev).repeat(S, 1, 1)
    dtm = dt[:, None, None]
    F[:, 0:3, 9:12] = -R_a * dtm
    F[:, 3:6, 6:9] = eye3 * dtm
    F[:, 6:9, 0:3] = -so3.hat(Ra) * dtm
    F[:, 6:9, 12:15] = -R_b * dtm
    F[:, 6:9, 21:24] = eye3 * dtm
    rates = const((config.gyro_noise,) * 3 + (1e-8,) * 3 + (config.acc_noise,) * 3
                  + (config.bias_rw,) * 6 + (config.extrinsic_rw,) * 6
                  + (config.gravity_rw,) * 3, dev)
    Q = torch.diag_embed(rates * dt[:, None])
    P = state.P
    for k in range(S):
        P = F[k] @ P @ F[k].T + Q[k]
    new_state = state._replace(R=R, p=p, v=v, P=0.5 * (P + P.T))
    return new_state, (R_a, torch.stack(ps))


def undistort(
    scan: pcl.PointCloud,
    point_time: torch.Tensor,
    Rs: torch.Tensor,
    ps: torch.Tensor,
    R_end: torch.Tensor,
    p_end: torch.Tensor,
    imu_t: torch.Tensor,
    R_li: torch.Tensor | None = None,
    t_li: torch.Tensor | None = None,
) -> pcl.PointCloud:
    """Motion-compensate LIDAR-frame points to the scan-end LIDAR frame
    (`UndistortPcl`): each point at sweep time t takes the propagated
    pose of the IMU sample that starts last at or before t (clipped to
    the packet at both ends), goes lidar -> IMU -> world, and is
    re-expressed in the end pose, then back in the lidar frame."""
    k = torch.clamp(torch.searchsorted(imu_t, point_time.contiguous(), right=True) - 1,
                    0, Rs.shape[0] - 1)
    xyz = scan.xyz
    if R_li is not None:
        xyz = xyz @ R_li.T + t_li
    world = (Rs[k] @ xyz[:, :, None])[..., 0] + ps[k]
    body_end = (world - p_end) @ R_end
    if R_li is not None:
        body_end = (body_end - t_li) @ R_li
    return pcl.park(pcl.PointCloud(body_end, scan.mask))


def update(state: LioState, scan_ds: pcl.PointCloud, config: LioConfig):
    """Iterated measurement update, MAP Gauss-Newton with the propagated
    prior over the full 24-dof error state. Residuals are point-to-plane
    on tp = R (R_li q + t_li) + p against planes pooled from the `direct7`
    cells, associated once at the IMU-predicted state; they constrain
    (dphi, dp) and, with `estimate_extrinsics`, (dphi_e, dp_e) through
    de/dphi_e = (R_li q) x (R^T n), de/dp_e = R^T n; velocity and biases
    move through the prior's cross-covariances. Returns (state, inliers
    of the last iteration)."""
    dev = state.P.device
    eye = torch.eye(_DOF, device=dev)
    eye3 = torch.eye(3, device=dev)
    Pinv = linalg3.inv_psd_scaled(state.P + 1e-9 * eye)
    w_meas = 1.0 / (config.lidar_noise ** 2)
    est_ext, est_grav = config.estimate_extrinsics, config.estimate_gravity

    # associate once at the IMU-predicted state
    s_b0 = scan_ds.xyz @ state.R_li.T + state.t_li
    tp0 = s_b0 @ state.R.T + state.p
    mu_p, Cp, wsum = registration.pooled_moments(state.grid, tp0)
    evals, V = linalg3.eigh3(Cp + 1e-9 * eye3)
    n = V[..., :, 0]
    planar = evals[..., 0] < 0.1 * torch.clamp(evals[..., 1], min=1e-9)
    usable = scan_ds.mask & (wsum >= 5) & planar

    def clamp(u):
        nrm = torch.linalg.norm(u)
        return u * torch.clamp(config.extrinsic_step / torch.clamp(nrm, min=1e-12), max=1.0)

    R, p, v, bg, ba = state.R, state.p, state.v, state.bg, state.ba
    R_li, t_li, grav = state.R_li, state.t_li, state.grav
    H = Pinv
    inliers = torch.zeros((), device=dev)
    for _ in range(config.iters):
        s_b = scan_ds.xyz @ R_li.T + t_li                  # IMU frame
        tp = s_b @ R.T + p
        d2 = torch.sum((mu_p - tp) ** 2, dim=-1)
        ok = usable & (d2 < config.max_corr_dist ** 2)
        w = ok.to(torch.float32) * w_meas
        r = torch.sum(n * (tp - mu_p), dim=-1)
        # R <- exp(dphi) R, p <- p + dp: de/dphi = (R s x n) . dphi
        cols = [torch.linalg.cross(tp - p, n, dim=-1), n]
        if est_ext:
            n_body = n @ R                                 # R^T n
            cols += [torch.linalg.cross(s_b - t_li, n_body, dim=-1), n_body]
        J = torch.cat(cols, dim=-1)                        # (N, 6 or 12)
        JtWJ = (J * w[:, None]).T @ J
        H = Pinv.clone()
        H[0:6, 0:6] += JtWJ[0:6, 0:6]
        if est_ext:
            H[0:6, 15:21] += JtWJ[0:6, 6:12]
            H[15:21, 0:6] += JtWJ[6:12, 0:6]
            H[15:21, 15:21] += JtWJ[6:12, 6:12]
        # prior residual: the deviation from the propagated state
        x_prior = torch.cat([
            so3.log(R @ state.R.T), p - state.p, v - state.v, bg - state.bg, ba - state.ba,
            so3.log(R_li @ state.R_li.T), t_li - state.t_li, grav - state.grav,
        ])
        Jtr = J.T @ (r * w)
        b_meas = torch.zeros(_DOF, device=dev)
        b_meas[0:6] = Jtr[0:6]
        if est_ext:
            b_meas[15:21] = Jtr[6:12]
        b = -b_meas - Pinv @ x_prior
        dx = linalg3.solve_psd_scaled(H + 1e-8 * eye, b)
        R = so3.exp(dx[0:3]) @ R
        if est_ext:
            R_li = so3.exp(clamp(dx[15:18])) @ R_li
            t_li = t_li + clamp(dx[18:21])
        if est_grav:
            # tangent step, then back onto the |g| = 9.81 sphere
            g_new = grav + dx[21:24]
            grav = g_new * (9.81 / torch.clamp(torch.linalg.norm(g_new), min=1e-9))
        p, v, bg, ba = p + dx[3:6], v + dx[6:9], bg + dx[9:12], ba + dx[12:15]
        inliers = torch.sum(ok)
    # information-form contraction at the converged estimate
    P_post = linalg3.inv_psd_scaled(H + 1e-8 * eye)
    state2 = state._replace(R=R, p=p, v=v, bg=bg, ba=ba, R_li=R_li, t_li=t_li, grav=grav,
                            P=0.5 * (P_post + P_post.T))
    return state2, inliers


def step(state: LioState, scan: pcl.PointCloud, point_time: torch.Tensor, imu: ImuSample,
         config: LioConfig):
    """One lidar-inertial frame: propagate -> undistort -> iterated
    update (from the second frame on) -> map insert and decay. `scan`
    is in the LIDAR frame; the map and pose are world / IMU. Returns
    (state, inliers)."""
    state, (Rs, ps) = propagate(state, imu, config)
    imu_t = torch.cumsum(imu.dt, dim=0) - imu.dt
    und = undistort(scan, point_time, Rs, ps, state.R, state.p, imu_t,
                    R_li=state.R_li, t_li=state.t_li)
    ds = pcl.voxel_downsample(und, config.scan_leaf, config.scan_capacity, bounds=_BOUNDS)
    if state.frame > 0:
        state, inliers = update(state, ds, config)
    else:
        inliers = torch.zeros((), dtype=torch.int64, device=state.p.device)
    fine = pcl.voxel_downsample(und, config.insert_leaf, config.insert_capacity, bounds=_BOUNDS)
    grid = voxel_grid.insert(state.grid, pcl.transform(fine, state.lidar_pose()))
    grid = voxel_grid.decay(grid, state.p, config.map_radius)
    return state._replace(grid=grid, frame=state.frame + 1), inliers
