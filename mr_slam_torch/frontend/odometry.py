"""Scan-to-map lidar odometry (port of `mr_slam_tpu/frontend/odometry.py`).

    downsample -> predict (constant velocity) -> coarse direct27 and
    fine (annealed) direct7 point-to-plane GN against a persistent
    voxel-hash Gaussian map -> insert -> decay

`state.frame` is a host integer, so the reference's `lax.cond`s on the
frame counter (first frame, decay and coarse-map cadences) are plain
Python `if`s with no device sync; `run` is a Python loop over frames.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.se3 import Pose
from ..ops import pointcloud as pcl
from ..ops import registration, voxel_grid
from . import preprocess

_BOUNDS = ((-150.0, -150.0, -150.0), (150.0, 150.0, 150.0))


class OdometryConfig(NamedTuple):
    scan_leaf: float = 0.4          # scan downsample for registration
    map_leaf: float = 1.0           # map voxel size (filter_size_map)
    insert_leaf: float = 0.15       # finer downsample for map insertion
    scan_capacity: int = 4096       # registration scan budget
    insert_capacity: int = 16384    # insertion cloud budget
    table_size: int = 1 << 17       # map hash slots
    map_radius: float = 120.0       # moving-FOV trim radius
    iters: int = 8                  # GN iterations per frame
    max_corr_dist: float = 1.0
    decay_every: int = 8            # FOV trim every N frames
    coarse_every: int = 4           # coarse-grid insert every N frames
    anneal: bool = True             # annealed fine-register association


class OdometryState(NamedTuple):
    grid: voxel_grid.VoxelGrid
    coarse_grid: voxel_grid.VoxelGrid  # 4x leaf, for wide-basin align
    pose: Pose        # world <- body, current frame
    prev_pose: Pose   # world <- body, previous frame
    frame: int        # frame counter (host)


def init(config: OdometryConfig, origin: Pose | None = None, device=None) -> OdometryState:
    """Empty maps on `device` (the origin's device when it is given)."""
    if origin is None:
        origin = se3.identity(device=device)
    dev = origin.t.device
    return OdometryState(
        grid=voxel_grid.empty(config.map_leaf, config.table_size, dev),
        coarse_grid=voxel_grid.empty(4.0 * config.map_leaf, config.table_size // 4, dev),
        pose=origin,
        prev_pose=origin,
        frame=0,
    )


def step(
    state: OdometryState,
    scan: pcl.PointCloud,
    config: OdometryConfig,
    t_rel: torch.Tensor | None = None,
    scan_period: float = 0.1,
    shed: bool = False,
):
    """Process one lidar frame (body-frame cloud). Returns (new_state,
    diagnostics dict).

    `t_rel`: optional (N,) per-point capture times from the sweep start.
    With them the scan is motion-compensated to the sweep-start frame by
    the constant-velocity prediction before it is downsampled (A-LOAM's
    `TransformToStart`); the registered and inserted clouds are the
    compensated one. `shed`: skip the map-refinement half (fine insert +
    decay) — the load-shedding mode; the pose still registers against
    the map."""
    motion = se3.between(state.prev_pose, state.pose)
    pred = se3.compose(state.pose, motion)
    if t_rel is not None:
        scan = preprocess.undistort_constant_velocity(scan, t_rel, motion, scan_period)
    ds = pcl.voxel_downsample(scan, config.scan_leaf, config.scan_capacity, bounds=_BOUNDS)

    if state.frame > 0:
        # coarse stage: 4x-leaf grid, direct27 probes, wide basin
        ds_coarse = pcl.voxel_downsample(
            ds, 2.0 * config.scan_leaf, max(config.scan_capacity // 4, 256),
        )
        coarse = registration.point_to_plane_icp(
            ds_coarse, state.coarse_grid, pred, iters=4,
            max_corr_dist=8.0 * config.map_leaf, neighbors="direct27", inner=1,
        )
        sched = None
        if config.anneal and config.iters >= 6:
            q = max(config.iters // 4, 1)
            sched = ((q, 4), (q, 2), (config.iters - 2 * q, 1))
        res = registration.point_to_plane_icp(
            ds, state.grid, coarse.pose, iters=config.iters,
            max_corr_dist=config.max_corr_dist, neighbors="direct7", inner=2,
            schedule=sched,
        )
        new_pose, err, inliers = res.pose, res.error, res.num_inliers
    else:
        zero = torch.zeros((), device=pred.t.device)
        new_pose, err, inliers = pred, zero, zero

    if shed:
        grid, coarse_grid = state.grid, state.coarse_grid
    else:
        # insert a finer cloud than the registration cloud so map cells
        # carry real covariance structure
        fine = pcl.voxel_downsample(
            scan, config.insert_leaf, config.insert_capacity, bounds=_BOUNDS
        )
        grid = voxel_grid.insert(state.grid, pcl.transform(fine, new_pose))
        if state.frame % config.decay_every == config.decay_every - 1:
            grid = voxel_grid.decay(grid, new_pose.t, config.map_radius)
        coarse_grid = state.coarse_grid
        if state.frame % config.coarse_every == 0 or state.frame < 4:
            coarse_grid = voxel_grid.insert(coarse_grid, pcl.transform(ds, new_pose))
            coarse_grid = voxel_grid.decay(coarse_grid, new_pose.t, config.map_radius)
    new_state = OdometryState(
        grid=grid, coarse_grid=coarse_grid, pose=new_pose,
        prev_pose=state.pose, frame=state.frame + 1,
    )
    return new_state, {"error": err, "inliers": inliers}


def run(scans: pcl.PointCloud, config: OdometryConfig, origin: Pose | None = None):
    """Offline odometry over a stacked (T, N, 3)/(T, N) sequence; returns
    (final state, (T,) trajectory, diagnostics)."""
    state = init(config, origin, device=scans.xyz.device)
    poses, errs, inls = [], [], []
    for i in range(scans.xyz.shape[0]):
        state, diag = step(state, pcl.PointCloud(scans.xyz[i], scans.mask[i]), config)
        poses.append(state.pose)
        errs.append(diag["error"])
        inls.append(diag["inliers"])
    return state, se3.stack(poses), {"error": torch.stack(errs), "inliers": torch.stack(inls)}
