"""The LIO front-end through the streaming entry point: `OnlineSlam`
sessions whose robots run `OdometryCfg(frontend="lio")`, fed by
`replay.synthetic_bag(with_imu=True)` through `replay`, port against
reference on the same frames; session files with LIO robots crossing
between the packages; the reference's error for a LIO frame without
its IMU packet. 2 robots, 3 frames at rest then 9 on a radius-10 circle
(phases 0 and 0.6 rad, 0.15 laps), 16x512 rays, 10 IMU samples a frame.

Bounds: the same keyframe counts; keyframe ATE within 1.25 x the
reference session's + 0.05 m; a session saved at frame CUT of the
stream and loaded into the other package holds every leaf of the LIO
state (`odo.{r}.{i}`, the voxel map included) equal, and continues to
the same keyframe counts; a port session resumed from its own file
finishes bit-identical to the uninterrupted one."""
import os

import jax
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import replay as trep, synthetic
from mr_slam_torch.frontend import lio as tlio
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_torch.runtime import checkpoint as tckpt
from mr_slam_torch.runtime import config as tcfg
from mr_slam_torch.runtime import online as tonline
from mr_slam_tpu.datasets import replay as jrep
from mr_slam_tpu.runtime import checkpoint as jckpt
from mr_slam_tpu.runtime import config as jcfg
from mr_slam_tpu.runtime import online as jonline
from tests.torch_parity import cloud_to_jax, imu_to_jax, pose_to_jax, rest_then_circle

REST, N = 3, 9
CUT = 12  # of the 24 interleaved frames


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
def bag():
    world = synthetic.default_world(0)
    trajs = [rest_then_circle(REST, N, radius=10.0, laps=0.15, phase=p) for p in (0.0, 0.6)]
    return trajs, trep.synthetic_bag(world, trajs, REST + N, with_imu=True)


def jax_frames(frames):
    return [jrep.Frame(stamp=f.stamp, robot=f.robot, scan=cloud_to_jax(f.scan),
                       origin=None if f.origin is None else pose_to_jax(f.origin),
                       imu=None if f.imu is None else imu_to_jax(f.imu)) for f in frames]


def ate(sess, traj, r) -> float:
    """Keyframe ATE of robot r's optimized poses (frame from the stamp)."""
    res = sess.result()
    store = res.robots[r].store
    K = int(store.count)
    frames = np.rint((np.asarray(store.stamps[:K], np.float64) - 0.03 * r) / 0.1).astype(int)
    est = np.asarray(res.opt_poses.t)[np.asarray(res.node_of[r][:K])]
    return float(np.sqrt(np.mean(np.sum((est - traj.t.numpy()[frames]) ** 2, -1))))


@pytest.fixture(scope="module")
def reference(bag, tmp_path_factory):
    """The reference session over the whole stream, and its file at CUT."""
    _, frames = bag
    jf = jax_frames(frames)
    whole = jonline.OnlineSlam(config(jcfg))
    jrep.replay(jf, whole)
    part = jonline.OnlineSlam(config(jcfg))
    jrep.replay(jf[:CUT], part)
    path = str(tmp_path_factory.mktemp("ref") / "lio.npz")
    jckpt.save_session(part, path)
    return whole, path


def test_synthetic_bag_carries_imu_packets(bag):
    trajs, frames = bag
    assert len(frames) == 2 * (REST + N)
    for f in frames:
        first = f.origin is not None
        assert (f.imu is None) == first
        if not first:
            g, a, d = f.imu
            assert g.shape == a.shape == (10, 3) and d.shape == (10,)
            assert torch.allclose(d.sum(), torch.tensor(0.1))


def test_lio_session_matches_reference(bag, reference):
    trajs, frames = bag
    whole, _ = reference
    sess = tonline.OnlineSlam(config(tcfg), device="cpu")
    assert trep.replay(frames, sess) == len(frames)
    assert all(rs["frontend"] == "lio" for rs in sess.robots.values())
    assert sess.robots[0]["odo"].frame == REST + N - 1  # frame 0 runs no filter step
    for r in range(2):
        assert sess.kf_counts[r] == int(whole.mstore.stores.count[whole.rows[r]]) >= 4
        a_port, a_ref = ate(sess, trajs[r], r), ate(whole, trajs[r], r)
        assert a_port <= 1.25 * a_ref + 0.05, (r, a_port, a_ref)
        assert a_port < 0.2


def test_lio_session_resume_is_bit_identical(bag, tmp_path):
    _, frames = bag
    whole = tonline.OnlineSlam(config(tcfg), device="cpu")
    trep.replay(frames, whole)
    want = whole.result()
    part = tonline.OnlineSlam(config(tcfg), device="cpu")
    trep.replay(frames[:CUT], part)
    path = os.path.join(tmp_path, "lio.npz")
    tckpt.save_session(part, path)
    resumed = tckpt.load_session(path, device="cpu")
    assert isinstance(resumed.robots[0]["odo"], tlio.LioState)
    assert resumed.robots[0]["odo"].frame == part.robots[0]["odo"].frame
    trep.replay(frames[CUT:], resumed)
    got = resumed.result()
    assert torch.equal(got.opt_poses.t, want.opt_poses.t)
    assert torch.equal(got.opt_poses.R, want.opt_poses.R)
    for r in range(2):
        assert torch.equal(resumed.robots[r]["odo"].P, whole.robots[r]["odo"].P)
        assert torch.equal(resumed.robots[r]["odo"].grid.packed, whole.robots[r]["odo"].grid.packed)


def test_lio_session_files_cross_both_ways(bag, reference, tmp_path):
    _, frames = bag
    whole, ref_path = reference
    part = tonline.OnlineSlam(config(tcfg), device="cpu")
    trep.replay(frames[:CUT], part)
    path = os.path.join(tmp_path, "port.npz")
    tckpt.save_session(part, path)
    into_ref = jckpt.load_session(path)
    for r in range(2):
        pl = [tckpt.to_numpy(v) for _, v in tckpt.flatten(part.robots[r]["odo"])]
        jl = [np.asarray(v) for v in jax.tree_util.tree_leaves(into_ref.robots[r]["odo"])]
        assert len(pl) == len(jl) == 12  # 9 state leaves, the grid's 2, the frame
        for i, (a, b) in enumerate(zip(pl, jl)):
            np.testing.assert_array_equal(a, b, err_msg=f"odo.{r}.{i}")
    jrep.replay(jax_frames(frames[CUT:]), into_ref)
    into_port = tckpt.load_session(ref_path, device="cpu")
    assert all(isinstance(rs["odo"], tlio.LioState) for rs in into_port.robots.values())
    trep.replay(frames[CUT:], into_port)
    for r in range(2):
        want = int(whole.mstore.stores.count[whole.rows[r]])
        assert int(into_ref.mstore.stores.count[into_ref.rows[r]]) == want
        assert into_port.kf_counts[r] == want


def test_lio_frame_without_imu_raises(bag):
    _, frames = bag
    sess = tonline.OnlineSlam(config(tcfg), device="cpu")
    first = frames[0]
    sess.register_robot(first.robot, first.origin)
    sess.add_frame(first.robot, first.scan, stamp=first.stamp)  # frame 0 needs none
    nxt = next(f for f in frames[1:] if f.robot == first.robot)
    with pytest.raises(ValueError, match="imu"):
        sess.add_frame(nxt.robot, nxt.scan, stamp=nxt.stamp)
    # scan2map robots take per-point times too
    s2m = tonline.OnlineSlam(config(tcfg).replace(odometry=tcfg.OdometryCfg()), device="cpu")
    s2m.register_robot(0, first.origin)
    t = torch.full((first.scan.xyz.shape[0],), 0.05)
    s2m.add_frame(0, first.scan, stamp=0.0, times=t)
    s2m.add_frame(0, tpcl.PointCloud(nxt.scan.xyz, nxt.scan.mask), stamp=0.1, times=t)
    assert s2m.robots[0]["odo"].frame == 2
