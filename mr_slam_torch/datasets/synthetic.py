"""Synthetic multi-robot lidar worlds with analytic raycasting (port of
`mr_slam_tpu/datasets/synthetic.py`: `World`, `default_world`,
`circle_trajectory`, `scan`, `scan_to_cloud`).

Data generation runs on the host in numpy and returns CPU tensors;
callers move them to their device. Random draws come from numpy
`default_rng(seed)`, so a world or a noise draw differs from the
reference's (`jax.random`) for the same seed: parity tests build a world
and its scans once here and hand the same arrays to both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import so3
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
