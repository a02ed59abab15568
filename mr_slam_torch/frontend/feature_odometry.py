"""A-LOAM-style feature odometry (port of `mr_slam_tpu/frontend/
feature_odometry.py`: `step`, `run`).

LOAM features from the range image (`ops/features.extract`), a coarse
point-to-plane alignment of the surfs against the 4x-leaf grid, then
corners to lines and surfs to planes in the persistent voxel map
(`ops/registration.loam_icp`); both maps take the frame every frame.
The state is the dense front-end's `OdometryState`, its frame counter on
the host, so the first-frame branch is a Python `if`; `run` is a Python
loop over frames where the reference has a `lax.scan`.
"""
from __future__ import annotations

import torch

from ..geometry import se3
from ..geometry.se3 import Pose
from ..ops import features as feat
from ..ops import pointcloud as pcl
from ..ops import registration, voxel_grid
from .odometry import _BOUNDS, OdometryConfig, OdometryState, init


def step(state: OdometryState, xyz_image: torch.Tensor, hit: torch.Tensor,
         config: OdometryConfig):
    """One frame: `xyz_image` (R, A, 3) body-frame range image, `hit`
    (R, A). Returns (state, {"error", "inliers"})."""
    f = feat.extract(xyz_image, hit)
    motion = se3.between(state.prev_pose, state.pose)
    pred = se3.compose(state.pose, motion)
    if state.frame > 0:
        coarse = registration.point_to_plane_icp(
            f.surfs, state.coarse_grid, pred, iters=3,
            max_corr_dist=8.0 * config.map_leaf, neighbors="direct27",
        )
        res = registration.loam_icp(
            f.corners, f.surfs, state.grid, coarse.pose,
            iters=config.iters, max_corr_dist=config.max_corr_dist,
        )
        new_pose, err, inliers = res.pose, res.error, res.num_inliers
    else:
        zero = torch.zeros((), device=xyz_image.device)
        new_pose, err, inliers = pred, zero, zero
    scan = pcl.park(pcl.PointCloud(xyz_image.reshape(-1, 3), hit.reshape(-1)))
    fine = pcl.voxel_downsample(scan, config.insert_leaf, config.insert_capacity, bounds=_BOUNDS)
    grid = voxel_grid.insert(state.grid, pcl.transform(fine, new_pose))
    grid = voxel_grid.decay(grid, new_pose.t, config.map_radius)
    ds = pcl.voxel_downsample(scan, config.scan_leaf, config.scan_capacity, bounds=_BOUNDS)
    cg = voxel_grid.insert(state.coarse_grid, pcl.transform(ds, new_pose))
    cg = voxel_grid.decay(cg, new_pose.t, config.map_radius)
    new_state = OdometryState(grid=grid, coarse_grid=cg, pose=new_pose, prev_pose=state.pose,
                              frame=state.frame + 1)
    return new_state, {"error": err, "inliers": inliers}


def run(xyz_images: torch.Tensor, hits: torch.Tensor, config: OdometryConfig,
        origin: Pose | None = None):
    """Offline batch over (T, R, A, 3) / (T, R, A) range images on their
    device. Returns (final state, (T,) poses, {"error", "inliers"})."""
    state = init(config, origin, device=xyz_images.device)
    poses, errs, inls = [], [], []
    for i in range(xyz_images.shape[0]):
        state, diag = step(state, xyz_images[i], hits[i], config)
        poses.append(state.pose)
        errs.append(diag["error"])
        inls.append(diag["inliers"])
    return state, se3.stack(poses), {"error": torch.stack(errs), "inliers": torch.stack(inls)}
