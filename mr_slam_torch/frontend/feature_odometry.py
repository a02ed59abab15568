"""A-LOAM-style feature odometry (port of `mr_slam_tpu/frontend/
feature_odometry.py`: `step`, `run`).

LOAM features from the range image (`ops/features.extract`), a coarse
point-to-plane alignment of the surfs against the 4x-leaf grid, then
corners to lines and surfs to planes in the persistent voxel map
(`ops/registration.loam_icp`); both maps take the frame every frame.
The state is the dense front-end's `OdometryState`, its frame counter on
the host, so the first-frame branch is a Python `if`. `run`, a
`lax.scan` of the jitted `step` in the reference, runs the frames
through one runner (`runtime/frame_graph.Loam`: CUDA-graph replays on
the card), bit-equal to the loop of `step` (`_run_eager`), which stays
as the oracle and calls the eager registration bodies.
"""
from __future__ import annotations

import torch

from ..geometry import se3
from ..geometry.se3 import Pose
from ..ops import features as feat
from ..ops import pointcloud as pcl
from ..ops import registration, voxel_grid
from .odometry import _BOUNDS, OdometryConfig, OdometryState, init


def predict(pose: Pose, prev_pose: Pose) -> Pose:
    """The constant-velocity prediction of the next pose."""
    motion = se3.between(prev_pose, pose)
    return se3.compose(pose, motion)


def coarse_kw(config: OdometryConfig) -> dict:
    """The coarse point-to-plane ICP's arguments (surfs, the coarse grid)."""
    return dict(iters=3, max_corr_dist=8.0 * config.map_leaf, neighbors="direct27")


def loam_kw(config: OdometryConfig) -> dict:
    """`loam_icp`'s arguments (corners and surfs, the fine grid)."""
    return dict(iters=config.iters, max_corr_dist=config.max_corr_dist)


def maintain(grid: voxel_grid.VoxelGrid, coarse_grid: voxel_grid.VoxelGrid,
             xyz_image: torch.Tensor, hit: torch.Tensor, pose: Pose,
             config: OdometryConfig) -> tuple[voxel_grid.VoxelGrid, voxel_grid.VoxelGrid]:
    """Both maps take the frame at `pose`, then drop cells beyond the map
    radius. Returns (grid, coarse grid)."""
    scan = pcl.park(pcl.PointCloud(xyz_image.reshape(-1, 3), hit.reshape(-1)))
    fine = pcl.voxel_downsample(scan, config.insert_leaf, config.insert_capacity, bounds=_BOUNDS)
    grid = voxel_grid.insert(grid, pcl.transform(fine, pose))
    grid = voxel_grid.decay(grid, pose.t, config.map_radius)
    ds = pcl.voxel_downsample(scan, config.scan_leaf, config.scan_capacity, bounds=_BOUNDS)
    cg = voxel_grid.insert(coarse_grid, pcl.transform(ds, pose))
    cg = voxel_grid.decay(cg, pose.t, config.map_radius)
    return grid, cg


def step(state: OdometryState, xyz_image: torch.Tensor, hit: torch.Tensor,
         config: OdometryConfig):
    """One frame: `xyz_image` (R, A, 3) body-frame range image, `hit`
    (R, A). Returns (state, {"error", "inliers"})."""
    f = feat.extract(xyz_image, hit)
    pred = predict(state.pose, state.prev_pose)
    if state.frame > 0:
        coarse = registration._point_to_plane_icp_eager(f.surfs, state.coarse_grid, pred,
                                                        **coarse_kw(config))
        res = registration._loam_icp_eager(f.corners, f.surfs, state.grid, coarse.pose,
                                           **loam_kw(config))
        new_pose, err, inliers = res.pose, res.error, res.num_inliers
    else:
        zero = torch.zeros((), device=xyz_image.device)
        new_pose, err, inliers = pred, zero, zero
    grid, cg = maintain(state.grid, state.coarse_grid, xyz_image, hit, new_pose, config)
    new_state = OdometryState(grid=grid, coarse_grid=cg, pose=new_pose, prev_pose=state.pose,
                              frame=state.frame + 1)
    return new_state, {"error": err, "inliers": inliers}


def run(xyz_images: torch.Tensor, hits: torch.Tensor, config: OdometryConfig,
        origin: Pose | None = None):
    """Offline batch over (T, R, A, 3) / (T, R, A) range images on their
    device. Returns (final state, (T,) poses, {"error", "inliers"})."""
    from ..runtime import frame_graph

    out = frame_graph.loam(xyz_images, hits, config, origin)
    return out.state, out.poses, {"error": out.error, "inliers": out.inliers}


def _run_eager(xyz_images: torch.Tensor, hits: torch.Tensor, config: OdometryConfig,
               origin: Pose | None = None):
    """`run` as the loop of `step`: the oracle of its runner."""
    state = init(config, origin, device=xyz_images.device)
    poses, errs, inls = [], [], []
    for i in range(xyz_images.shape[0]):
        state, diag = step(state, xyz_images[i], hits[i], config)
        poses.append(state.pose)
        errs.append(diag["error"])
        inls.append(diag["inliers"])
    return state, se3.stack(poses), {"error": torch.stack(errs), "inliers": torch.stack(inls)}
