"""Scan-to-map lidar odometry (port of `mr_slam_tpu/frontend/odometry.py`).

    downsample -> predict (constant velocity) -> coarse direct27 and
    fine (annealed) direct7 point-to-plane GN against a persistent
    voxel-hash Gaussian map -> insert -> decay

`state.frame` is a host integer, so the reference's `lax.cond`s on the
frame counter (first frame, decay and coarse-map cadences) are plain
Python `if`s with no device sync. `step` is cut into its stages
(`predict`, `register_coarse`, `register_fine`, `insert_fine`,
`decay_fine`, `insert_coarse`) at its two SO(3) projections and at its
host branches; `run` drives them through `runtime/frame_graph`, whose
CUDA graphs replay them on the card (the counterpart of the
reference's `lax.scan`).
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


def predict(pose: Pose, prev_pose: Pose, scan: pcl.PointCloud, config: OdometryConfig,
            t_rel: torch.Tensor | None = None, scan_period: float = 0.1):
    """A step's first stage: the constant-velocity prediction, the motion
    compensation (with `t_rel`) and the registration downsample. Returns
    (pred, the compensated scan, ds)."""
    motion = se3.between(prev_pose, pose)
    pred = se3.compose(pose, motion)
    if t_rel is not None:
        scan = preprocess.undistort_constant_velocity(scan, t_rel, motion, scan_period)
    ds = pcl.voxel_downsample(scan, config.scan_leaf, config.scan_capacity, bounds=_BOUNDS)
    return pred, scan, ds


def register_coarse(ds: pcl.PointCloud, coarse_grid: voxel_grid.VoxelGrid, pred: Pose,
                    config: OdometryConfig) -> registration.RegistrationResult:
    """The coarse stage: the 4x-leaf grid, direct27 probes, a wide basin.
    The pose is not yet projected onto SO(3) (`se3.normalize`)."""
    ds_coarse = pcl.voxel_downsample(ds, 2.0 * config.scan_leaf, max(config.scan_capacity // 4, 256))
    return registration.point_to_plane_icp_raw(
        ds_coarse, coarse_grid, pred, iters=4,
        max_corr_dist=8.0 * config.map_leaf, neighbors="direct27", inner=1,
    )


def register_fine(ds: pcl.PointCloud, grid: voxel_grid.VoxelGrid, coarse_pose: Pose,
                  config: OdometryConfig) -> registration.RegistrationResult:
    """The fine stage: the annealed direct7 pass from the projected coarse
    pose. The pose is not yet projected onto SO(3)."""
    sched = None
    if config.anneal and config.iters >= 6:
        q = max(config.iters // 4, 1)
        sched = ((q, 4), (q, 2), (config.iters - 2 * q, 1))
    return registration.point_to_plane_icp_raw(
        ds, grid, coarse_pose, iters=config.iters,
        max_corr_dist=config.max_corr_dist, neighbors="direct7", inner=2,
        schedule=sched,
    )


def insert_fine(grid: voxel_grid.VoxelGrid, scan: pcl.PointCloud, pose: Pose,
                config: OdometryConfig) -> voxel_grid.VoxelGrid:
    """Insert a finer cloud than the registration cloud, so map cells
    carry real covariance structure."""
    fine = pcl.voxel_downsample(scan, config.insert_leaf, config.insert_capacity, bounds=_BOUNDS)
    return voxel_grid.insert(grid, pcl.transform(fine, pose))


def decay_fine(grid: voxel_grid.VoxelGrid, pose: Pose,
               config: OdometryConfig) -> voxel_grid.VoxelGrid:
    """The fine map's moving-FOV trim (every `decay_every` frames)."""
    return voxel_grid.decay(grid, pose.t, config.map_radius)


def insert_coarse(coarse_grid: voxel_grid.VoxelGrid, ds: pcl.PointCloud, pose: Pose,
                  config: OdometryConfig) -> voxel_grid.VoxelGrid:
    """The coarse map's insert and trim (every `coarse_every` frames and
    on the first four)."""
    coarse_grid = voxel_grid.insert(coarse_grid, pcl.transform(ds, pose))
    return voxel_grid.decay(coarse_grid, pose.t, config.map_radius)


def decays(frame: int, config: OdometryConfig) -> bool:
    return frame % config.decay_every == config.decay_every - 1


def inserts_coarse(frame: int, config: OdometryConfig) -> bool:
    return frame % config.coarse_every == 0 or frame < 4


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
    the map.

    The stages are the functions above, called in turn; the CUDA-graph
    runner (`runtime/frame_graph.py`) calls the same ones, with the two
    SO(3) projections between its graphs."""
    pred, scan, ds = predict(state.pose, state.prev_pose, scan, config, t_rel, scan_period)
    if state.frame > 0:
        coarse = register_coarse(ds, state.coarse_grid, pred, config)
        res = register_fine(ds, state.grid, se3.normalize(coarse.pose), config)
        new_pose, err, inliers = se3.normalize(res.pose), res.error, res.num_inliers
    else:
        zero = torch.zeros((), device=pred.t.device)
        new_pose, err, inliers = pred, zero, zero

    grid, coarse_grid = state.grid, state.coarse_grid
    if not shed:
        grid = insert_fine(grid, scan, new_pose, config)
        if decays(state.frame, config):
            grid = decay_fine(grid, new_pose, config)
        if inserts_coarse(state.frame, config):
            coarse_grid = insert_coarse(coarse_grid, ds, new_pose, config)
    new_state = OdometryState(
        grid=grid, coarse_grid=coarse_grid, pose=new_pose,
        prev_pose=state.pose, frame=state.frame + 1,
    )
    return new_state, {"error": err, "inliers": inliers}


def run(scans: pcl.PointCloud, config: OdometryConfig, origin: Pose | None = None):
    """Offline odometry over a stacked (T, N, 3)/(T, N) sequence; returns
    (final state, (T,) trajectory, diagnostics). On the card the frames
    replay as CUDA graphs (`runtime/frame_graph.scan2map`), on the CPU
    the same stages run eagerly."""
    from ..runtime import frame_graph

    if origin is None:
        origin = se3.identity(device=scans.xyz.device)
    out = frame_graph.scan2map(scans, config, origin)
    return out.state, out.poses, {"error": out.error, "inliers": out.inliers}
