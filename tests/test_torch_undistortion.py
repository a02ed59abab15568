"""Motion compensation in the batch entry point, port against reference:
the reference's "undistortion required and sufficient" case
(`tests/test_undistortion.py`) — a robot 4 frames at rest, then 12
frames of a radius-12 circle at 0.45 laps (0.25 rad of yaw per sweep),
every 16x512-ray scan sheared by the motion the constant-velocity model
predicts for it (`synthetic.shear_scan`) — through scan2map
`pipeline.run_frontend` with and without the point times.

Bounds: with times, the ATE of the odometry positions within 1.25 x
the reference's + 0.05 m, the final drift under 0.6 m (the reference
test's bound); without them, more than twice that drift, in both
packages."""
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_torch.runtime import config as tcfg
from mr_slam_torch.runtime import pipeline as tpipe
from mr_slam_tpu.runtime import config as jcfg
from mr_slam_tpu.runtime import pipeline as jpipe
from tests.torch_parity import cloud_to_jax, make_scans, pose_to_jax, rest_then_circle, to_jax


def config(m):
    return m.SlamConfig(
        odometry=m.OdometryCfg(scan_capacity=4096, insert_capacity=8192, table_size=1 << 16),
        keyframes=m.KeyframeCfg(capacity=16, points_per_kf=2048),
    )


@pytest.fixture(scope="module")
def sheared():
    traj = rest_then_circle(4, 12, radius=12.0, laps=0.45)
    n = traj.t.shape[0]
    clean = make_scans(synthetic.default_world(3), traj, n, seed=0, n_rings=16, n_azimuth=512)
    rel = tse3.between(tse3.index(traj, slice(0, n - 1)), tse3.index(traj, slice(1, n)))
    xyz, mask, times = [], [], []
    for i in range(n):
        s, t = synthetic.shear_scan(tpcl.PointCloud(clean.xyz[i], clean.mask[i]),
                                    tse3.index(rel, max(i - 2, 0)), 0.1)
        xyz.append(s.xyz)
        mask.append(s.mask)
        times.append(t)
    return traj, tpcl.PointCloud(torch.stack(xyz), torch.stack(mask)), torch.stack(times)


def drift(odom_t, traj) -> float:
    return float(np.linalg.norm(np.asarray(odom_t[-1]) - traj.t[-1].numpy()))


def ate(odom_t, traj) -> float:
    err = np.asarray(odom_t, np.float64) - traj.t.numpy()
    return float(np.sqrt(np.mean(np.sum(err * err, axis=-1))))


@pytest.mark.parametrize("with_times", [True, False])
def test_scan2map_undistortion_matches_reference(sheared, with_times):
    traj, scans, times = sheared
    t = times if with_times else None
    got = tpipe.run_frontend(scans, config(tcfg), tse3.index(traj, 0), times=t)
    want = jpipe.run_frontend(cloud_to_jax(scans), config(jcfg), pose_to_jax(tse3.index(traj, 0)),
                              times=None if t is None else to_jax(t))
    d_port, d_ref = drift(got.odom_poses.t, traj), drift(want.odom_poses.t, traj)
    if with_times:
        a_port, a_ref = ate(got.odom_poses.t, traj), ate(want.odom_poses.t, traj)
        assert a_port <= 1.25 * a_ref + 0.05, (a_port, a_ref)
        assert d_port < 0.6
    else:
        compensated = tpipe.run_frontend(scans, config(tcfg), tse3.index(traj, 0), times=times)
        d_with = drift(compensated.odom_poses.t, traj)
        assert d_port > 2.0 * d_with, (d_port, d_with)
        assert d_ref > 2.0 * d_with
