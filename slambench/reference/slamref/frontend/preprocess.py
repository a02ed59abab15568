"""Sensor preprocessing: lidar models, ring / time assignment, range-image
projection, motion undistortion (port of `mr_slam_tpu/frontend/
preprocess.py`).

The reference system's two preprocessing front doors as tensor ops:
A-LOAM's ring assignment by vertical angle and per-point sweep time from
azimuth (`scanRegistration.cpp:171-259`), and FAST-LIO's lidar handlers
(`preprocess.cpp`: blind zone, point skipping, Livox time offsets).
Everything keeps fixed shapes: an unordered (N, 3) cloud scatters into a
(rings x azimuth) range image for `ops/features.extract`, and the
constant-velocity undistortion is A-LOAM's `TransformToStart` with the
slerp as scaled SO(3) log / exp.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import so3
from ..geometry.se3 import Pose
from ..ops import pointcloud as pcl


class LidarModel(NamedTuple):
    """Static spinning-lidar geometry. Angles in degrees."""

    n_rings: int
    fov_up: float
    fov_down: float
    blind: float = 0.5       # drop points closer than this (m)
    max_range: float = 150.0
    scan_period: float = 0.1  # seconds per sweep


# presets of the reference's supported sensors
VLP16 = LidarModel(n_rings=16, fov_up=15.0, fov_down=-15.0)
HDL32 = LidarModel(n_rings=32, fov_up=10.67, fov_down=-30.67)
HDL64 = LidarModel(n_rings=64, fov_up=2.0, fov_down=-24.33)
OS1_64 = LidarModel(n_rings=64, fov_up=16.6, fov_down=-16.6, blind=1.0)
# Livox AVIA: ring = the sensor's line id (6 lines), time = per-point offset
AVIA = LidarModel(n_rings=6, fov_up=38.4, fov_down=-38.4, blind=1.0)

_TWO_PI = 2.0 * math.pi


def vertical_angles(xyz: torch.Tensor) -> torch.Tensor:
    """Elevation angle in degrees per point (...,)."""
    r_xy = torch.linalg.norm(xyz[..., :2], dim=-1)
    return torch.rad2deg(torch.atan2(xyz[..., 2], torch.clamp(r_xy, min=1e-9)))


def assign_rings(xyz: torch.Tensor, model: LidarModel):
    """Ring index by vertical angle, linear over the field of view, to
    the nearest ring (round half to even, as the reference). Returns
    (ring (...,) int32, valid (...,) bool): out-of-FOV points are
    invalid."""
    ang = vertical_angles(xyz)
    frac = (ang - model.fov_down) / (model.fov_up - model.fov_down)
    ring = torch.round(frac * (model.n_rings - 1)).to(torch.int32)
    valid = (ang >= model.fov_down - 1e-3) & (ang <= model.fov_up + 1e-3)
    return torch.clamp(ring, 0, model.n_rings - 1), valid


def azimuth(xyz: torch.Tensor) -> torch.Tensor:
    """Clockwise sweep angle in [0, 2 pi), the reference's `-atan2(y, x)`."""
    return torch.remainder(-torch.atan2(xyz[..., 1], xyz[..., 0]), _TWO_PI)


def relative_times(xyz: torch.Tensor, model: LidarModel, start_azimuth=None) -> torch.Tensor:
    """Per-point relative sweep time (...,) in [0, scan_period]: the
    azimuth phase from the sweep start (the first point's azimuth unless
    `start_azimuth` is given), unwrapped once."""
    phi = azimuth(xyz)
    if start_azimuth is None:
        phi0 = phi[..., :1]
    else:
        phi0 = torch.as_tensor(start_azimuth, dtype=phi.dtype, device=phi.device)
        phi0 = phi0[..., None] if phi0.dim() else phi0
    rel = torch.remainder(phi - phi0, _TWO_PI)
    return model.scan_period * rel / _TWO_PI


def blind_filter(pc: pcl.PointCloud, model: LidarModel) -> pcl.PointCloud:
    """Drop points in the blind zone or beyond max range."""
    r = torch.linalg.norm(pc.xyz, dim=-1)
    return pcl.park(pcl.PointCloud(pc.xyz, pc.mask & (r > model.blind) & (r < model.max_range)))


def point_skip(pc: pcl.PointCloud, every: int) -> pcl.PointCloud:
    """Keep every k-th slot (`point_filter_num` decimation)."""
    if every <= 1:
        return pc
    idx = torch.arange(pc.capacity, device=pc.xyz.device)
    return pcl.park(pcl.PointCloud(pc.xyz, pc.mask & (idx % every == 0)))


def to_range_image(pc: pcl.PointCloud, model: LidarModel, n_azimuth: int = 1024):
    """Scatter an unordered cloud (N, 3) into a (rings, n_azimuth) range
    image for `ops/features.extract`. Returns (xyz (R, A, 3) with the
    sentinel in empty cells, hit (R, A), times (R, A) sweep-relative).

    The nearest return wins a cell. The reference scatters the minimum
    range and lets any point at that range write; here each point's key
    (float32 range bits, then its index) is reduced by an integer
    minimum per cell, so the winner is the nearest point, the lower
    index first, whatever order the device scatters in."""
    n = pc.xyz.shape[-2]
    ring, rv = assign_rings(pc.xyz, model)
    phi = azimuth(pc.xyz)
    # nearest bin centre with wraparound (truncation would split points
    # on the bin edges, where a real sensor's azimuths lie, across cells)
    col = torch.remainder(torch.round(phi / _TWO_PI * n_azimuth).to(torch.int64), n_azimuth)
    rng = torch.linalg.norm(pc.xyz, dim=-1)
    valid = pc.mask & rv & (rng > model.blind) & (rng < model.max_range)
    size = model.n_rings * n_azimuth
    flat = torch.where(valid, ring.to(torch.int64) * n_azimuth + col, size)
    # ranges are positive: their float32 bits order as the values
    key = rng.contiguous().view(torch.int32).to(torch.int64) * (1 << 31) \
        + torch.arange(n, device=rng.device)
    big = torch.iinfo(torch.int64).max
    best = torch.full((size + 1,), big, dtype=torch.int64, device=rng.device)
    best = best.scatter_reduce(0, flat, key, reduce="amin")[:size]
    hit = best != big
    winner = torch.where(hit, best & ((1 << 31) - 1), 0)
    img = torch.where(hit[:, None], pc.xyz[winner], pcl.SENTINEL)
    t_rel = model.scan_period * phi / _TWO_PI
    times = torch.where(hit, t_rel[winner], 0.0)
    R, A = model.n_rings, n_azimuth
    return img.reshape(R, A, 3), hit.reshape(R, A), times.reshape(R, A)


def undistort_constant_velocity(
    pc: pcl.PointCloud,
    t_rel: torch.Tensor,
    delta: Pose,
    scan_period: float,
) -> pcl.PointCloud:
    """A-LOAM `TransformToStart`: each point, captured at `t_rel`, in
    the sweep-start frame, for a constant velocity over the sweep given
    by `delta` (sweep end in sweep start); slerp(I -> delta, s =
    t / period) as scaled SO(3) / R^3 log-exp."""
    s = torch.clamp(t_rel / scan_period, 0.0, 1.0)
    R_s = so3.exp(s[..., None] * so3.log(delta.R))
    xyz = torch.einsum("nij,nj->ni", R_s, pc.xyz) + s[..., None] * delta.t
    return pcl.park(pcl.PointCloud(xyz, pc.mask))


def livox_preprocess(
    xyz: torch.Tensor,
    offset_time: torch.Tensor,
    line: torch.Tensor,
    model: LidarModel = AVIA,
    skip: int = 1,
):
    """The Livox AVIA handler: the sensor gives per-point time offsets
    (s) and line ids; blind zone and decimation. Returns (cloud, t_rel,
    ring)."""
    pc = point_skip(blind_filter(pcl.make(xyz), model), skip)
    return pc, offset_time, torch.clamp(line.to(torch.int32), 0, model.n_rings - 1)
