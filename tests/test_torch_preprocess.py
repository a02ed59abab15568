"""Sensor preprocessing of the port against the reference
(`frontend/preprocess.py`, and `datasets/synthetic`'s `shear_scan` /
`imu_for_trajectory`) on the same numpy inputs: a 16x512-ray scan of a
radius-20 ring road, and uniform random clouds.

Tolerances: integers (rings, hit masks, range-image cells) exact; floats
(angles in degrees, times, points) 1e-6 absolute apart from
`vertical_angles` (1e-4 degrees: libm's atan2); the constant-velocity
undistortion and `shear_scan` 1e-5; a shear followed by the
undistortion gives the clean scan back within 1e-4 m (the reference
test's bound); IMU packets 1e-5."""
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.frontend import preprocess as tpre
from mr_slam_torch.geometry import se3 as tse3, so3 as tso3
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_tpu.datasets import synthetic as jsyn
from mr_slam_tpu.frontend import preprocess as jpre
from tests.torch_parity import cloud_to_jax, make_scans, pose_to_jax, to_jax, to_torch

MODELS = ["VLP16", "HDL32", "HDL64", "OS1_64", "AVIA"]


@pytest.fixture(scope="module")
def scan():
    world = synthetic.default_world(9)
    traj = synthetic.circle_trajectory(2, radius=20.0, laps=0.05)
    scans = make_scans(world, traj, 2, seed=0, n_rings=16, n_azimuth=512)
    return tpcl.PointCloud(scans.xyz[1], scans.mask[1])


def sensor_frame(pc):
    """The raycaster's points in the sensor frame (0.8 m above the body)."""
    return tpcl.park(tpcl.PointCloud(pc.xyz - torch.tensor([0.0, 0.0, 0.8]), pc.mask))


def random_cloud(seed, n=500, lo=-30.0, hi=30.0):
    xyz = np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)
    return tpcl.PointCloud(torch.from_numpy(xyz), torch.ones(n, dtype=torch.bool))


@pytest.mark.parametrize("name", MODELS)
def test_rings_angles_and_azimuth(scan, name):
    pc = sensor_frame(scan)
    tm, jm = getattr(tpre, name), getattr(jpre, name)
    assert tuple(tm) == tuple(jm)
    ring, valid = tpre.assign_rings(pc.xyz, tm)
    jring, jvalid = jpre.assign_rings(to_jax(pc.xyz), jm)
    np.testing.assert_array_equal(ring.numpy(), np.asarray(jring))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tpre.vertical_angles(pc.xyz).numpy(),
                               np.asarray(jpre.vertical_angles(to_jax(pc.xyz))), atol=1e-4)
    np.testing.assert_allclose(tpre.azimuth(pc.xyz).numpy(),
                               np.asarray(jpre.azimuth(to_jax(pc.xyz))), atol=1e-6)


def test_relative_times(scan):
    pc = sensor_frame(scan)
    m = tpre.VLP16
    np.testing.assert_allclose(tpre.relative_times(pc.xyz, m).numpy(),
                               np.asarray(jpre.relative_times(to_jax(pc.xyz), m)), atol=1e-6)
    np.testing.assert_allclose(tpre.relative_times(pc.xyz, m, start_azimuth=1.0).numpy(),
                               np.asarray(jpre.relative_times(to_jax(pc.xyz), m, 1.0)), atol=1e-6)
    batch = torch.stack([pc.xyz[:100], pc.xyz[100:200]])
    np.testing.assert_allclose(tpre.relative_times(batch, m).numpy(),
                               np.asarray(jpre.relative_times(to_jax(batch), m)), atol=1e-6)
    t = tpre.relative_times(pc.xyz, m)
    assert float(t.min()) >= 0.0 and float(t.max()) <= m.scan_period


@pytest.mark.parametrize("every", [1, 3])
def test_blind_filter_point_skip_and_livox(every):
    pc = random_cloud(1, lo=-2.0, hi=2.0)
    m = tpre.OS1_64
    for got, want in ((tpre.blind_filter(pc, m), jpre.blind_filter(cloud_to_jax(pc), m)),
                      (tpre.point_skip(pc, every), jpre.point_skip(cloud_to_jax(pc), every))):
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    rng = np.random.default_rng(2)
    off = torch.from_numpy(rng.uniform(0, 0.1, 500).astype(np.float32))
    line = torch.from_numpy(rng.integers(-1, 8, 500).astype(np.int32))
    got = tpre.livox_preprocess(pc.xyz, off, line, skip=every)
    want = jpre.livox_preprocess(to_jax(pc.xyz), to_jax(off), to_jax(line), skip=every)
    np.testing.assert_array_equal(got[0].mask.numpy(), np.asarray(want[0].mask))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("n_azimuth", [512, 1024])
def test_range_image(scan, n_azimuth):
    """Cells, hit mask and times of the scan, and of the scan with every
    point doubled 1 m farther out (the nearer return must win)."""
    pc = sensor_frame(scan)
    far = tpcl.PointCloud(torch.cat([pc.xyz * 1.2, pc.xyz]), torch.cat([pc.mask, pc.mask]))
    for cloud in (pc, far):
        img, hit, times = tpre.to_range_image(cloud, tpre.VLP16, n_azimuth)
        jimg, jhit, jtimes = jpre.to_range_image(cloud_to_jax(cloud), jpre.VLP16, n_azimuth)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
        np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-6)
        np.testing.assert_allclose(times.numpy(), np.asarray(jtimes), atol=1e-6)
        assert int(hit.sum()) > 1000


def test_undistort_constant_velocity():
    pc = random_cloud(3)
    t = torch.from_numpy(np.random.default_rng(4).uniform(-0.01, 0.11, 500).astype(np.float32))
    delta = tse3.Pose(tso3.exp(torch.tensor([0.02, -0.01, 0.3])), torch.tensor([1.0, -0.5, 0.1]))
    got = tpre.undistort_constant_velocity(pc, t, delta, 0.1)
    want = jpre.undistort_constant_velocity(cloud_to_jax(pc), to_jax(t), pose_to_jax(delta), 0.1)
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), atol=1e-5)


def test_shear_then_undistort_gives_the_clean_scan():
    pc = random_cloud(0)
    delta = tse3.Pose(tso3.exp(torch.tensor([0.0, 0.0, 0.3])), torch.tensor([1.0, -0.5, 0.0]))
    sheared, t_rel = synthetic.shear_scan(pc, delta, scan_period=0.1)
    jsheared, jt = jsyn.shear_scan(cloud_to_jax(pc), pose_to_jax(delta), scan_period=0.1)
    np.testing.assert_allclose(sheared.xyz.numpy(), np.asarray(jsheared.xyz), atol=1e-5)
    np.testing.assert_allclose(t_rel.numpy(), np.asarray(jt), atol=1e-6)
    assert float(torch.linalg.norm(sheared.xyz - pc.xyz, dim=-1).max()) > 1.0
    restored = tpre.undistort_constant_velocity(sheared, t_rel, delta, 0.1)
    np.testing.assert_allclose(restored.xyz.numpy(), pc.xyz.numpy(), atol=1e-4)


def test_imu_for_trajectory():
    traj = synthetic.circle_trajectory(12, radius=20.0, laps=0.1)
    got = synthetic.imu_for_trajectory(traj, frame_dt=0.1, n_sub=20)
    want = jsyn.imu_for_trajectory(pose_to_jax(traj), frame_dt=0.1, n_sub=20)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    noisy = synthetic.imu_for_trajectory(traj, n_sub=20, rng=np.random.default_rng(0),
                                         gyro_noise=1e-3, acc_noise=1e-2)
    assert 0.0 < float((noisy[0] - got[0]).abs().max()) < 1e-2
    np.testing.assert_array_equal(to_torch(want[2]).numpy(), noisy[2].numpy())
