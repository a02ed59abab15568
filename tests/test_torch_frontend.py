"""Scan-to-map odometry + keyframe gating of the port against the
reference on the same scans (12 frames, 16x512 rays).

Trajectories are compared by ATE against ground truth, not pose by pose:
the point-to-plane association pools f32 voxel moments in world
coordinates, whose cancellation follows summation order, so the two
packages' per-frame poses differ by millimetres to centimetres and
drift apart chaotically. Bound: port ATE within 10% + 2 cm of the
reference's; keyframe count within +-1."""
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.eval import metrics as tmet
from mr_slam_torch.frontend import keyframes as tkf, odometry as todo
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_torch.runtime import pipeline as tpipe
from mr_slam_torch.runtime.config import OdometryCfg, SlamConfig
from mr_slam_tpu.eval import metrics as jmet
from mr_slam_tpu.frontend import odometry as jodo
from mr_slam_tpu.runtime import pipeline as jpipe
from tests.torch_parity import cloud_to_jax, make_scans, pose_to_jax, to_jax
from mr_slam_tpu.runtime.config import OdometryCfg as JOdometryCfg
from mr_slam_tpu.runtime.config import SlamConfig as JSlamConfig

N_FRAMES = 12


@pytest.fixture(scope="module")
def sequence():
    world = synthetic.default_world(0)
    traj = synthetic.circle_trajectory(N_FRAMES, radius=25.0, laps=0.1)
    return traj, make_scans(world, traj, N_FRAMES, seed=1, n_rings=16, n_azimuth=512)


def within(a_port, a_ref):
    assert abs(a_port - a_ref) <= 0.1 * a_ref + 0.02, (a_port, a_ref)


def test_odometry_run_ate_matches_reference(sequence):
    traj, scans = sequence
    cfg = todo.OdometryConfig(table_size=1 << 16)
    _, poses, diag = todo.run(scans, cfg, tse3.index(traj, 0))
    jcfg = jodo.OdometryConfig(table_size=1 << 16)
    _, jposes, _ = jodo.run(cloud_to_jax(scans), jcfg, pose_to_jax(tse3.index(traj, 0)))
    a_port = float(tmet.ate(poses, traj).rmse)
    a_ref = float(jmet.ate(jposes, pose_to_jax(traj)).rmse)
    within(a_port, a_ref)
    assert a_port < 0.2
    assert diag["inliers"].shape == (N_FRAMES,)


def test_run_frontend_keyframes_match_reference(sequence):
    traj, scans = sequence
    cfg = SlamConfig(odometry=OdometryCfg(table_size=1 << 16))
    res = tpipe.run_frontend(scans, cfg, tse3.index(traj, 0))
    jres = jpipe.run_frontend(cloud_to_jax(scans), JSlamConfig(
        odometry=JOdometryCfg(table_size=1 << 16)), pose_to_jax(tse3.index(traj, 0)))
    K, JK = int(res.store.count), int(jres.store.count)
    assert abs(K - JK) <= 1 and K >= 3
    within(float(tmet.ate(res.odom_poses, traj).rmse),
           float(jmet.ate(jres.odom_poses, pose_to_jax(traj)).rmse))
    # keyframe bookkeeping: frames, stamps and stored poses line up
    kf_idx = torch.as_tensor(res.kf_frame_idx)
    np.testing.assert_array_equal(res.store.stamps[:K].numpy(), res.kf_frame_idx.astype(np.float32))
    np.testing.assert_allclose(res.store.poses.t[:K].numpy(),
                               res.odom_poses.t[kf_idx].numpy(), atol=1e-6)
    assert int(res.store.mask[:K].sum(1).min()) > 100


def test_maybe_add_gate_and_capacity():
    store = tkf.init(2, 64)
    cloud = tpcl.PointCloud(torch.randn(200, 3), torch.ones(200, dtype=torch.bool))
    steps = [0.0, 0.5, 2.5, 5.0, 9.0]  # gate 2.0: adds at 0, 2.5, 5.0 -> full after 2
    added = []
    for i, x in enumerate(steps):
        pose = tse3.Pose(torch.eye(3), torch.tensor([x, 0.0, 0.0]))
        store, add = tkf.maybe_add(store, cloud, pose, torch.tensor(float(i)), dist_thresh=2.0)
        added.append(bool(add))
    assert added == [True, False, True, False, False]
    assert int(store.count) == 2
    np.testing.assert_array_equal(store.stamps.numpy(), [0.0, 2.0])
