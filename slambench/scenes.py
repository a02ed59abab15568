"""Frozen copies of the port's scene generators, on the device of their
inputs: the courtyard world (`datasets/synthetic.default_world`), the
batched raycaster (`scan_batch`), the ring road (`circle_trajectory`),
body-frame IMU packets (`imu_for_trajectory`), per-point sweep times
(`frontend/preprocess.relative_times`) and the sweep that ends at the
scan's pose (`shear_to_end` of the port's chip smoke test).

The only change: the raycaster takes its range noise as a tensor
(`draw`, (T, rings, azimuth) standard normals), so a cell draws it on
the card from its seed; the port's version draws it from a numpy
generator."""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .reference.slamref.geometry import se3, so3
from .reference.slamref.geometry.se3 import Pose
from .reference.slamref.ops.pointcloud import PointCloud, park

SENSOR_HEIGHT = 0.8
FOV = (15.0, -25.0)  # the raycaster's beams (up, down), degrees


class World(NamedTuple):
    boxes: np.ndarray  # (M, 2, 3) float32 min / max corners; ground z = 0


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


def ray_dirs(n_rings: int, n_azimuth: int, fov_up=FOV[0], fov_down=FOV[1]) -> np.ndarray:
    """Velodyne-style beam directions, (rings, azimuth, 3) float32."""
    elev = np.deg2rad(np.linspace(fov_down, fov_up, n_rings, dtype=np.float32))
    azim = np.linspace(-np.pi, np.pi, n_azimuth, endpoint=False, dtype=np.float32)
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(azim)[None, :], np.sin(azim)[None, :]
    return np.stack(
        [ce * ca, ce * sa, np.broadcast_to(se, (n_rings, n_azimuth))], axis=-1
    ).astype(np.float32)


def scan_batch(world: World, poses: Pose, n_rings: int, n_azimuth: int, noise: float,
               draw: torch.Tensor | None, max_range: float = 80.0,
               sensor_height: float = SENSOR_HEIGHT) -> PointCloud:
    """Raycast a trajectory (T,) at once on the device of `poses`: xyz
    (T, R*A, 3) in the body frame, mask (T, R*A), with `noise * draw`
    added to every range."""
    dev = poses.t.device
    T = poses.t.shape[0]
    R = poses.R.to(torch.float32)
    t = poses.t.to(torch.float32)
    dirs = torch.from_numpy(ray_dirs(n_rings, n_azimuth)).to(dev)
    dirs_w = torch.einsum("raj,tij->trai", dirs, R)
    up = torch.tensor([0.0, 0.0, sensor_height], dtype=torch.float32, device=dev)
    o = (t + R @ up)[:, None, None, :]
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
    if draw is not None:
        rng_t = rng_t + noise * draw
    pts_w = o + rng_t[..., None] * dirs_w
    pts_b = torch.einsum("trai,tij->traj", pts_w - t[:, None, None, :], R)
    return park(PointCloud(pts_b.reshape(T, -1, 3), hit.reshape(T, -1)))


def circle_trajectory(n_frames: int, radius: float = 30.0, z: float = 0.0, laps: float = 1.1,
                      center=(0.0, 0.0), phase: float = 0.0, ccw: bool = True) -> Pose:
    """Ring-road trajectory. Returns a batched float32 CPU Pose (n_frames,)."""
    s = 1.0 if ccw else -1.0
    ang = (phase + s * np.linspace(0.0, 2 * np.pi * laps, n_frames)).astype(np.float32)
    x = center[0] + radius * np.cos(ang)
    y = center[1] + radius * np.sin(ang)
    yaw = torch.from_numpy(ang + np.float32(s * np.pi / 2))  # tangent heading
    t = np.stack([x, y, np.full_like(x, z)], axis=-1).astype(np.float32)
    return Pose(so3.yaw_rot(yaw), torch.from_numpy(t))


def imu_for_trajectory(traj: Pose, frame_dt: float = 0.1, n_sub: int = 10):
    """Noise-free body-frame IMU packets between consecutive poses:
    (gyro (T-1, n_sub, 3), acc (T-1, n_sub, 3), dt (T-1, n_sub))."""
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
    dts = torch.full((T - 1, n_sub), frame_dt / n_sub, dtype=torch.float32, device=dev)
    return gyro, acc, dts


_TWO_PI = 2.0 * math.pi


def relative_times(xyz: torch.Tensor, scan_period: float, start_azimuth: float = 0.0):
    """Per-point sweep time (...,) in [0, scan_period]: the clockwise
    azimuth (-atan2(y, x) in [0, 2 pi)) from `start_azimuth`, unwrapped
    once."""
    phi = torch.remainder(-torch.atan2(xyz[..., 1], xyz[..., 0]), _TWO_PI)
    phi0 = torch.as_tensor(start_azimuth, dtype=phi.dtype, device=phi.device)
    rel = torch.remainder(phi - phi0, _TWO_PI)
    return scan_period * rel / _TWO_PI


def shear_to_end(cloud: PointCloud, rel: Pose, t_rel: torch.Tensor, period: float = 0.1):
    """A sweep that ENDS at the scan's pose (FAST-LIO's stamping): the
    point captured at fraction s of the sweep is recorded from the pose
    slerped between the previous frame and this one, p_rec = R(s)^T
    (X_end p + p_end - p(s)) under `rel` (previous frame <- this one)."""
    xi = so3.log(rel.R)
    s = torch.clamp(t_rel / period, 0.0, 1.0)
    R_rest = so3.exp((1.0 - s)[:, None] * xi)
    t_rest = torch.einsum("nij,j->ni", so3.exp(-s[:, None] * xi), rel.t) * (1.0 - s)[:, None]
    return park(PointCloud(torch.einsum("nij,nj->ni", R_rest, cloud.xyz) + t_rest, cloud.mask))


def shear_to_end_batch(cloud: PointCloud, rel: Pose, t_rel: torch.Tensor, period: float = 0.1):
    """`shear_to_end` over a batch of sweeps: cloud (T, N), rel (T,),
    t_rel (T, N)."""
    xi = so3.log(rel.R)                                          # (T, 3)
    s = torch.clamp(t_rel / period, 0.0, 1.0)                    # (T, N)
    R_rest = so3.exp((1.0 - s)[..., None] * xi[:, None, :])      # (T, N, 3, 3)
    t_rest = torch.einsum("tnij,tj->tni", so3.exp(-s[..., None] * xi[:, None, :]), rel.t) \
        * (1.0 - s)[..., None]
    return park(PointCloud(torch.einsum("tnij,tnj->tni", R_rest, cloud.xyz) + t_rest, cloud.mask))
