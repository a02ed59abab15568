"""Synthetic multi-robot lidar worlds with analytic raycasting (port of
`mr_slam_tpu/datasets/synthetic.py`, every function of it).

Worlds, trajectories and single scans are made on the host in numpy and
returned as CPU tensors; `scan_batch` raycasts a whole trajectory on the
device of its poses, and `imu_for_trajectory`, `perturb_trajectory` and
`shear_scan` work on the device of their input. Random draws come from
numpy `default_rng(seed)` generators, so a world or a noise draw differs
from the reference's (`jax.random`) for the same seed: parity tests
build a world and its scans once here and hand the same arrays to both
packages.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3, so3
from ..geometry.se3 import Pose
from ..ops.pointcloud import PointCloud, park


class World(NamedTuple):
    """Axis-aligned boxes (M, 2, 3) float32: [:, 0] = min corner,
    [:, 1] = max. The ground plane at z = 0 is implicit."""

    boxes: np.ndarray


def default_world(seed: int = 0, extent: float = 60.0, n_boxes: int = 24) -> World:
    """A courtyard: perimeter walls + random buildings/pillars, with a
    clear ring road at radius ~0.38-0.68 extent."""
    rng = np.random.default_rng(seed)
    e = extent
    walls = np.array(
        [
            [[-e, -e, 0.0], [e, -e + 0.5, 4.0]],
            [[-e, e - 0.5, 0.0], [e, e, 4.0]],
            [[-e, -e, 0.0], [-e + 0.5, e, 4.0]],
            [[e - 0.5, -e, 0.0], [e, e, 4.0]],
        ]
    )
    centers = rng.uniform(-e * 0.8, e * 0.8, (n_boxes, 2))
    sizes = rng.uniform(1.0, 6.0, (n_boxes, 2))
    heights = rng.uniform(2.0, 8.0, (n_boxes, 1))
    r = np.linalg.norm(centers, axis=-1, keepdims=True)
    push = np.where((r > 0.38 * e) & (r < 0.68 * e), 0.72 * e / np.maximum(r, 1.0), 1.0)
    centers = centers * push
    lo = np.concatenate([centers - sizes / 2, np.zeros((n_boxes, 1))], axis=-1)
    hi = np.concatenate([centers + sizes / 2, heights], axis=-1)
    boxes = np.concatenate([walls, np.stack([lo, hi], axis=1)], axis=0)
    return World(boxes.astype(np.float32))


def _ray_dirs(n_rings: int, n_azimuth: int, fov_up=15.0, fov_down=-25.0) -> np.ndarray:
    """Velodyne-style beam directions, (rings, azimuth, 3) float32."""
    elev = np.deg2rad(np.linspace(fov_down, fov_up, n_rings, dtype=np.float32))
    azim = np.linspace(-np.pi, np.pi, n_azimuth, endpoint=False, dtype=np.float32)
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(azim)[None, :], np.sin(azim)[None, :]
    return np.stack(
        [ce * ca, ce * sa, np.broadcast_to(se, (n_rings, n_azimuth))], axis=-1
    ).astype(np.float32)


def scan(
    world: World,
    pose: Pose,
    n_rings: int = 32,
    n_azimuth: int = 512,
    max_range: float = 80.0,
    sensor_height: float = 0.8,
    noise: float = 0.01,
    rng: np.random.Generator | None = None,
):
    """Raycast one spinning-lidar frame from `pose` (a single Pose; the
    sensor sits `sensor_height` above the body origin). Range noise
    `noise * N(0, 1)` is drawn from `rng` when given.

    Returns (xyz_body (R, A, 3), range (R, A), hit (R, A)) as CPU tensors
    in the BODY frame."""
    R = np.asarray(pose.R, np.float32)
    t = np.asarray(pose.t, np.float32)
    dirs_w = _ray_dirs(n_rings, n_azimuth) @ R.T
    o = (t + R @ np.array([0.0, 0.0, sensor_height], np.float32)).astype(np.float32)
    dz = dirs_w[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ground = np.where(dz < -1e-6, -o[2] / dz, np.inf).astype(np.float32)
    lo = world.boxes[:, 0]
    hi = world.boxes[:, 1]
    inv_d = 1.0 / np.where(np.abs(dirs_w) < 1e-9, np.float32(1e-9), dirs_w)
    t_box = np.full(dz.shape, np.inf, np.float32)
    for m in range(lo.shape[0]):  # slab test, one box at a time
        t0 = (lo[m] - o) * inv_d
        t1 = (hi[m] - o) * inv_d
        tmin = np.max(np.minimum(t0, t1), axis=-1)
        tmax = np.min(np.maximum(t0, t1), axis=-1)
        hit_box = (tmax >= np.maximum(tmin, 1e-3)) & (tmin > 1e-3)
        t_box = np.minimum(t_box, np.where(hit_box, tmin, np.inf))
    rng_t = np.minimum(t_ground, t_box)
    hit = np.isfinite(rng_t) & (rng_t <= max_range) & (rng_t > 0.5)
    rng_t = np.where(hit, rng_t, np.float32(max_range)).astype(np.float32)
    if rng is not None:
        rng_t = (rng_t + noise * rng.standard_normal(rng_t.shape)).astype(np.float32)
    pts_w = o + rng_t[..., None] * dirs_w
    pts_b = ((pts_w - t) @ R).astype(np.float32)
    return torch.from_numpy(pts_b), torch.from_numpy(rng_t), torch.from_numpy(hit)


def scan_batch(
    world: World,
    poses: Pose,
    n_rings: int = 32,
    n_azimuth: int = 512,
    max_range: float = 80.0,
    sensor_height: float = 0.8,
    noise: float = 0.01,
    rng: np.random.Generator | None = None,
) -> PointCloud:
    """Raycast a whole trajectory (T,) at once on the device of `poses`:
    `scan` + `scan_to_cloud` for every pose, stacked as xyz (T, R*A, 3),
    mask (T, R*A). The range noise is drawn from `rng` as one (T, R, A)
    block, the draws `scan` makes frame by frame from the same
    generator."""
    dev = poses.t.device
    T = poses.t.shape[0]
    R = poses.R.to(torch.float32)
    t = poses.t.to(torch.float32)
    dirs = torch.from_numpy(_ray_dirs(n_rings, n_azimuth)).to(dev)          # (Ra, A, 3)
    dirs_w = torch.einsum("raj,tij->trai", dirs, R)                         # (T, Ra, A, 3)
    up = torch.tensor([0.0, 0.0, sensor_height], dtype=torch.float32, device=dev)
    o = (t + R @ up)[:, None, None, :]                                      # (T, 1, 1, 3)
    dz = dirs_w[..., 2]
    t_ground = torch.where(dz < -1e-6, -o[..., 2] / dz, torch.inf)
    inv_d = 1.0 / torch.where(torch.abs(dirs_w) < 1e-9, 1e-9, dirs_w)
    boxes = torch.from_numpy(world.boxes).to(dev)
    t_box = torch.full(dz.shape, torch.inf, device=dev)
    for m in range(boxes.shape[0]):  # slab test, one box at a time over the whole batch
        t0 = (boxes[m, 0] - o) * inv_d
        t1 = (boxes[m, 1] - o) * inv_d
        tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
        tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
        hit_box = (tmax >= torch.clamp(tmin, min=1e-3)) & (tmin > 1e-3)
        t_box = torch.minimum(t_box, torch.where(hit_box, tmin, torch.inf))
    rng_t = torch.minimum(t_ground, t_box)
    hit = torch.isfinite(rng_t) & (rng_t <= max_range) & (rng_t > 0.5)
    rng_t = torch.where(hit, rng_t, max_range)
    if rng is not None:
        draw = rng.standard_normal((T, n_rings, n_azimuth))
        rng_t = rng_t + noise * torch.from_numpy(draw.astype(np.float32)).to(dev)
    pts_w = o + rng_t[..., None] * dirs_w
    pts_b = torch.einsum("trai,tij->traj", pts_w - t[:, None, None, :], R)
    return park(PointCloud(pts_b.reshape(T, -1, 3), hit.reshape(T, -1)))


def scan_to_cloud(xyz_body: torch.Tensor, hit: torch.Tensor) -> PointCloud:
    """Flatten a range image into a masked cloud."""
    return park(PointCloud(xyz_body.reshape(-1, 3), hit.reshape(-1)))


def circle_trajectory(
    n_frames: int,
    radius: float = 30.0,
    z: float = 0.0,
    laps: float = 1.1,
    center=(0.0, 0.0),
    phase: float = 0.0,
    ccw: bool = True,
) -> Pose:
    """Ring-road trajectory (laps > 1 revisits its start). Returns a
    batched float32 CPU Pose (n_frames,)."""
    s = 1.0 if ccw else -1.0
    ang = (phase + s * np.linspace(0.0, 2 * np.pi * laps, n_frames)).astype(np.float32)
    x = center[0] + radius * np.cos(ang)
    y = center[1] + radius * np.sin(ang)
    yaw = torch.from_numpy(ang + np.float32(s * np.pi / 2))  # tangent heading
    t = np.stack([x, y, np.full_like(x, z)], axis=-1).astype(np.float32)
    return Pose(so3.yaw_rot(yaw), torch.from_numpy(t))


def multi_robot_trajectories(
    n_robots: int, n_frames: int, radius: float = 30.0, extent: float = 60.0
) -> Pose:
    """(n_robots, n_frames) poses on one ring road, robot r starting at
    phase 2 pi r / n_robots and alternating direction, so robots
    traverse shared regions (inter-robot loop closures exist)."""
    trajs = [
        circle_trajectory(n_frames, radius=radius, phase=2 * np.pi * r / max(n_robots, 1),
                          ccw=(r % 2 == 0))
        for r in range(n_robots)
    ]
    return Pose(torch.stack([t.R for t in trajs]), torch.stack([t.t for t in trajs]))


def _perturb_with(traj: Pose, dt: torch.Tensor, dw: torch.Tensor) -> Pose:
    """`traj` (T,) re-integrated from its relative motions with the
    translation noise `dt` (T-1, 3) added and the rotation noise
    exp(`dw`) (T-1, 3) applied on the left of each relative rotation,
    from the first pose on."""
    n = traj.t.shape[0]
    rel = se3.between(se3.index(traj, slice(0, n - 1)), se3.index(traj, slice(1, n)))
    step_t = rel.t + dt
    step_R = so3.exp(dw) @ rel.R
    cur = se3.index(traj, 0)
    Rs, ts = [cur.R], [cur.t]
    for k in range(n - 1):
        cur = se3.compose(cur, Pose(step_R[k], step_t[k]))
        Rs.append(cur.R)
        ts.append(cur.t)
    return Pose(torch.stack(Rs), torch.stack(ts))


def perturb_trajectory(traj: Pose, trans_sigma: float = 0.02, rot_sigma: float = 0.002,
                       rng: np.random.Generator | None = None) -> Pose:
    """Integrate noisy relative motions — odometry drift with exact
    ground truth for ATE. The translation, then the rotation noise
    (T-1, 3) are drawn from `rng` (a fresh `default_rng(0)` if None)."""
    rng = np.random.default_rng(0) if rng is None else rng
    n = traj.t.shape[0]
    dev = traj.t.device
    dt = trans_sigma * rng.standard_normal((n - 1, 3))
    dw = rot_sigma * rng.standard_normal((n - 1, 3))
    return _perturb_with(traj, torch.from_numpy(dt.astype(np.float32)).to(dev),
                         torch.from_numpy(dw.astype(np.float32)).to(dev))


def imu_for_trajectory(
    traj: Pose,
    frame_dt: float = 0.1,
    n_sub: int = 10,
    rng: np.random.Generator | None = None,
    gyro_noise: float = 0.0,
    acc_noise: float = 0.0,
):
    """Body-frame IMU packets between consecutive poses of `traj` (T,):
    constant body rate from the pose geodesic over each frame interval,
    specific force from world-acceleration finite differences plus the
    gravity reaction, at the interval start attitude. Gyro, then accel
    noise are drawn from `rng` when given. Returns (gyro (T-1, n_sub, 3),
    acc (T-1, n_sub, 3), dt (T-1, n_sub)) on the trajectory's device."""
    T = traj.t.shape[0]
    dev = traj.t.device
    rel = se3.between(se3.index(traj, slice(0, T - 1)), se3.index(traj, slice(1, T)))
    w_body = so3.log(rel.R) / frame_dt
    v_w = (traj.t[1:] - traj.t[:-1]) / frame_dt
    dv = torch.diff(v_w, dim=0, prepend=v_w[:1]) / frame_dt
    g_world = torch.tensor([0.0, 0.0, -9.81], device=dev)
    f_body = torch.einsum("tba,tb->ta", traj.R[:-1], dv - g_world)
    gyro = w_body[:, None, :].repeat(1, n_sub, 1)
    acc = f_body[:, None, :].repeat(1, n_sub, 1)
    if rng is not None:
        gyro = gyro + gyro_noise * torch.from_numpy(
            rng.standard_normal(gyro.shape).astype(np.float32)).to(dev)
        acc = acc + acc_noise * torch.from_numpy(
            rng.standard_normal(acc.shape).astype(np.float32)).to(dev)
    dts = torch.full((T - 1, n_sub), frame_dt / n_sub, dtype=torch.float32, device=dev)
    return gyro, acc, dts


def shear_scan(cloud: PointCloud, delta: Pose, scan_period: float = 0.1):
    """A spinning-lidar sweep recorded while the sensor moves: `cloud`
    is an instantaneous scan in the sweep-START body frame, `delta` the
    sensor motion over the sweep (sweep end in sweep start). Each point,
    stamped by its azimuth (one revolution per sweep), is re-expressed
    in the sensor frame at its capture time,

        p_rec = R_s^T (p_start - t_s),  (R_s, t_s) = slerp(I -> delta, s),

    the exact inverse of `preprocess.undistort_constant_velocity`.
    Returns (sheared cloud, t_rel (N,) sweep-relative capture times)."""
    phi = torch.remainder(torch.atan2(cloud.xyz[:, 1], cloud.xyz[:, 0]), 2 * np.pi)
    t_rel = scan_period * phi / (2 * np.pi)
    s = t_rel / scan_period
    R_s = so3.exp(s[:, None] * so3.log(delta.R))
    t_s = s[:, None] * delta.t
    rec = torch.einsum("nji,nj->ni", R_s, cloud.xyz - t_s)
    return park(PointCloud(rec, cloud.mask)), t_rel
