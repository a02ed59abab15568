"""The LIO front-end through the batch entry point: `runtime.pipeline.run`
with `OdometryCfg(frontend="lio")` and IMU packets, port against
reference on the same inputs — 2 robots on a radius-10 circle (phases 0
and 0.6 rad, 0.3 laps over 20 frames) after 3 frames at rest (a filter
starts with v = 0), 16x512 rays with 2 mm of jitter, noise-free IMU
packets of 10 samples per frame (`synthetic.imu_for_trajectory`).

Bounds: the same keyframe counts and accepted (robot, keyframe) loop
pairs, >= 1 inter-robot loop; per-robot keyframe ATE within 1.25 x the
reference's + 0.05 m and under 0.2 m. Without IMU packets a LIO robot's
`pipeline.run` falls back to scan2map, as the reference's does."""
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.eval import metrics as tmet
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.runtime import config as tcfg
from mr_slam_torch.runtime import pipeline as tpipe
from mr_slam_tpu.runtime import config as jcfg
from mr_slam_tpu.runtime import pipeline as jpipe
from tests.torch_parity import (
    cloud_to_jax, imu_to_jax, jitter, make_scans, pose_to_jax, rest_then_circle, to_torch,
)

REST, N = 3, 20


def config(m):
    return m.SlamConfig(
        n_robots=2,
        odometry=m.OdometryCfg(frontend="lio", table_size=1 << 15, scan_capacity=2048,
                               insert_capacity=4096),
        keyframes=m.KeyframeCfg(dist_thresh=1.5, capacity=32, points_per_kf=2048),
        loops=m.LoopCfg(dist_thresh=0.4, min_separation=4, verify_capacity=4096,
                        fitness_thresh=0.3),
        pgo=m.PGOCfg(node_capacity=128, edge_capacity=256),
    )


@pytest.fixture(scope="module")
def runs():
    world = synthetic.default_world(0)
    trajs = [rest_then_circle(REST, N, radius=10.0, laps=0.3, phase=p) for p in (0.0, 0.6)]
    scans = [jitter(make_scans(world, t, REST + N, seed=r, n_rings=16, n_azimuth=512), 0.002,
                    10 + r) for r, t in enumerate(trajs)]
    imus = [synthetic.imu_for_trajectory(t, frame_dt=0.1, n_sub=10) for t in trajs]
    origins = [tse3.index(t, 0) for t in trajs]
    port = tpipe.run(scans, config(tcfg), origins=origins, imus=imus, device="cpu")
    ref = jpipe.run([cloud_to_jax(s) for s in scans], config(jcfg),
                    origins=[pose_to_jax(o) for o in origins], imus=[imu_to_jax(i) for i in imus])
    return trajs, scans, port, ref


def keyframe_ate(res, traj, r) -> float:
    est = res.optimized_trajectory(r)
    true = tse3.index(traj, torch.as_tensor(np.asarray(res.robots[r].kf_frame_idx)))
    return float(tmet.ate(tse3.Pose(to_torch(est.R), to_torch(est.t)), true).rmse)


def loop_keys(res):
    return sorted((l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"]) for l in res.loops)


def test_lio_pipeline_loops_match_reference(runs):
    _, _, port, ref = runs
    assert any(l["robot_a"] != l["robot_b"] for l in ref.loops), "scenario broken"
    assert loop_keys(port) == loop_keys(ref)
    for r in range(2):
        assert int(port.robots[r].store.count) == int(ref.robots[r].store.count) >= 5
        np.testing.assert_array_equal(port.robots[r].kf_frame_idx, ref.robots[r].kf_frame_idx)


@pytest.mark.parametrize("r", [0, 1])
def test_lio_pipeline_ate_matches_reference(runs, r):
    trajs, _, port, ref = runs
    a_port, a_ref = keyframe_ate(port, trajs[r], r), keyframe_ate(ref, trajs[r], r)
    assert a_port <= 1.25 * a_ref + 0.05, (a_port, a_ref)
    assert a_port < 0.2
    # the raw LIO odometry, frame by frame
    odo = port.robots[r].odom_poses
    assert odo.t.shape == (REST + N, 3)
    assert float(torch.linalg.norm(odo.t[-1] - trajs[r].t[-1])) < 0.2


def test_lio_without_imu_runs_scan2map(runs):
    trajs, scans, _, _ = runs
    cfg = config(tcfg)
    short = type(scans[0])(scans[0].xyz[:4], scans[0].mask[:4])
    got = tpipe.run_frontend(short, cfg, tse3.index(trajs[0], 0))
    want = tpipe.run_frontend(short, cfg.replace(odometry=tcfg.OdometryCfg(
        table_size=1 << 15, scan_capacity=2048, insert_capacity=4096)), tse3.index(trajs[0], 0))
    assert torch.equal(got.odom_poses.t, want.odom_poses.t)
