"""A-LOAM feature odometry of the port against the reference: feature
extraction (`ops/features.extract`), corner-to-line / surf-to-plane
registration (`ops/registration.loam_icp`) and the 12-frame
`frontend/feature_odometry.run` of the reference test (radius 25, 0.06
laps, 16x512 rays, range images by `preprocess.to_range_image`).

Tolerances: corner and surf masks equal, their points within 1e-6;
`loam_icp` on a room's features against its map within 1e-4 m and
1e-3 degrees of the reference's pose; the whole run by keyframe-free ATE, within
1.25 x the reference's + 0.05 m, and final error under 0.5 m (the
reference test's bound)."""
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.eval import metrics as tmet
from mr_slam_torch.frontend import feature_odometry as tfo, odometry as todo
from mr_slam_torch.frontend import preprocess as tpre
from mr_slam_torch.geometry import se3 as tse3, so3 as tso3
from mr_slam_torch.ops import features as tfeat, pointcloud as tpcl
from mr_slam_torch.ops import registration as treg, voxel_grid as tvg
from mr_slam_tpu.eval import metrics as jmet
from mr_slam_tpu.frontend import feature_odometry as jfo, odometry as jodo
from mr_slam_tpu.ops import features as jfeat, registration as jreg
from tests.torch_parity import (
    cloud_to_jax, grid_to_jax, make_scans, pose_to_jax, room, rot_diff_deg, to_jax, to_torch,
)

N = 12
MODEL = tpre.LidarModel(n_rings=16, fov_up=15.0, fov_down=-25.0)  # the raycaster's FOV


@pytest.fixture(scope="module")
def images():
    """(traj, (T, 16, 512, 3) range images, (T, 16, 512) hits) in the
    body frame, binned in the sensor frame."""
    world = synthetic.default_world(0)
    traj = synthetic.circle_trajectory(N, radius=25.0, laps=0.06)
    scans = make_scans(world, traj, N, seed=0, n_rings=16, n_azimuth=512)
    up = torch.tensor([0.0, 0.0, 0.8])
    xyz, hit = [], []
    for i in range(N):
        img, h, _ = tpre.to_range_image(
            tpcl.park(tpcl.PointCloud(scans.xyz[i] - up, scans.mask[i])), MODEL, 512)
        xyz.append(torch.where(h[..., None], img + up, img))
        hit.append(h)
    return traj, torch.stack(xyz), torch.stack(hit)


def test_extract(images):
    _, xyz, hit = images
    for i in (0, 5):
        got = tfeat.extract(xyz[i], hit[i])
        want = jfeat.extract(to_jax(xyz[i]), to_jax(hit[i]))
        for g, w in ((got.corners, want.corners), (got.surfs, want.surfs)):
            np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
            np.testing.assert_allclose(g.xyz.numpy(), np.asarray(w.xyz), atol=1e-6)
        np.testing.assert_allclose(got.curvature.numpy(), np.asarray(want.curvature),
                                   rtol=1e-5, atol=1e-6)
        assert int(got.corners.mask.sum()) > 20 and int(got.surfs.mask.sum()) > 100


def test_extract_ties_take_the_lower_index():
    """A straight wall sampled every 0.25 m: away from the azimuth seam
    every curvature is exactly 0, so every surf pick is a tie."""
    a = torch.arange(60, dtype=torch.float32)
    xyz = torch.stack([torch.full_like(a, 5.0), a * 0.25, torch.zeros_like(a)], -1)
    xyz = xyz[None].repeat(2, 1, 1)
    hit = torch.ones(2, 60, dtype=torch.bool)
    got = tfeat.extract(xyz, hit, n_sectors=2)
    want = jfeat.extract(to_jax(xyz), to_jax(hit), n_sectors=2)
    np.testing.assert_array_equal(got.surfs.mask.numpy(), np.asarray(want.surfs.mask))
    np.testing.assert_array_equal(got.surfs.xyz.numpy(), np.asarray(want.surfs.xyz))


@pytest.mark.parametrize("iters", [3, 10])
def test_loam_icp(iters):
    """Surfs and corners of a room against its dense map, from 0.3 m and
    3 degrees off (`torch_parity.room`: on a scan's features 25 m out the
    GN fixed point moves by 0.5 mm with the summation order, and the
    reference's own jitted and op-by-op runs part by more)."""
    planes, lines = room(0, 20000, 400)
    grid = tvg.insert(tvg.empty(1.0, 1 << 14), tpcl.make(torch.cat([planes, lines])))
    jgrid = grid_to_jax(grid)
    true = tse3.Pose(tso3.exp(torch.tensor([0.01, -0.02, 0.05])), torch.tensor([0.3, -0.2, 0.05]))
    inv = tse3.inverse(true)
    planes, lines = room(1, 600, 30)
    surfs = tpcl.make(tse3.apply(inv, planes))
    corners = tpcl.make(tse3.apply(inv, lines))
    init = tse3.identity()
    got = treg.loam_icp(corners, surfs, grid, init, iters=iters)
    want = jreg.loam_icp(cloud_to_jax(corners), cloud_to_jax(surfs), jgrid, pose_to_jax(init),
                         iters=iters)
    assert float(torch.linalg.norm(got.pose.t - to_torch(want.pose.t))) <= 1e-4
    assert rot_diff_deg(got.pose.R, want.pose.R) <= 1e-3
    assert float(got.num_inliers) == float(want.num_inliers) > 800
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-3)
    assert float(torch.linalg.norm(got.pose.t - true.t)) < 0.02
    assert rot_diff_deg(got.pose.R, true.R) < 0.2


def test_feature_odometry_run(images):
    traj, xyz, hit = images
    cfg = todo.OdometryConfig(table_size=1 << 16)
    _, poses, diag = tfo.run(xyz, hit, cfg, tse3.index(traj, 0))
    _, jposes, _ = jfo.run(to_jax(xyz), to_jax(hit), jodo.OdometryConfig(table_size=1 << 16),
                           pose_to_jax(tse3.index(traj, 0)))
    a_port = float(tmet.ate(poses, traj).rmse)
    a_ref = float(jmet.ate(jposes, pose_to_jax(traj)).rmse)
    assert a_port <= 1.25 * a_ref + 0.05, (a_port, a_ref)
    assert float(torch.linalg.norm(poses.t[-1] - traj.t[-1])) < 0.5
    assert diag["inliers"].shape == (N,) and float(diag["inliers"][-1]) > 50
